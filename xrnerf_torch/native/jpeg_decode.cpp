// Baseline and extended-sequential Huffman JPEG decoding (ITU T.81, SOF0 and
// SOF1, 8-bit samples) for xrnerf_torch/utils/jpeg.py, which parses the
// markers and hands over the tables and each scan's entropy-coded bytes.
//
// The pixel stages follow libjpeg(-turbo)'s defaults, the decode Pillow (and
// so imageio) gives, bit for bit:
//   - dequantisation and the integer "islow" IDCT of jidctint.c (CONST_BITS 13,
//     PASS1_BITS 2) with its rounding and its 10-bit range-limit table;
//   - libjpeg-turbo's jdsample.c: "fancy" triangle upsampling for h2v1 and
//     h2v2 (when the component is wider than 2 samples) and h1v2, each with
//     its edge rule (the first and last samples, rows and columns, repeat),
//     plain replication for every other integral factor;
//   - jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16).
//
// Build: g++ -O3 -shared -fPIC -o libjpeg_decode.so jpeg_decode.cpp
// (native/__init__.py builds it into xrnerf_torch/_build/ on first use and
// binds it with ctypes).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural (row-major) index; 16 extra entries absorb a
// corrupt run past the last coefficient, as libjpeg's table does
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Status : int64_t { kOk = 0, kTruncated = 1, kBadCode = 2, kNoRestart = 3 };

constexpr int kLookBits = 9;

struct Huffman {
    uint16_t look[1 << kLookBits];  // (code length << 8) | symbol; 0 where the code is longer
    int32_t maxcode[17];            // largest code of each length, -1 for none
    int32_t valoffset[17];
    uint8_t vals[256];

    // bits: the 16 code counts, then the symbols (jdhuff.c jpeg_make_d_derived_tbl;
    // the Python side has checked the table)
    void build(const uint8_t* bits) {
        const uint8_t* sym = bits + 16;
        std::memset(look, 0, sizeof(look));
        int p = 0, code = 0;
        for (int l = 1; l <= 16; ++l) {
            const int n = bits[l - 1];
            if (n) {
                valoffset[l] = p - code;
                for (int i = 0; i < n; ++i, ++p, ++code) {
                    vals[p] = sym[p];
                    if (l <= kLookBits) {
                        const int shift = kLookBits - l;
                        for (int j = 0; j < (1 << shift); ++j)
                            look[(code << shift) | j] = uint16_t((l << 8) | sym[p]);
                    }
                }
                maxcode[l] = code - 1;
            } else {
                maxcode[l] = -1;
                valoffset[l] = 0;
            }
            code <<= 1;
        }
    }
};

// MSB-first bit reader over entropy-coded bytes: undoes FF00 stuffing, stops
// at a marker, and feeds zero bits past it while counting them, so that
// reading into them is known to be truncated data.
struct BitReader {
    const uint8_t* d;
    int64_t n, pos = 0;
    uint64_t acc = 0;
    int nbits = 0, pad = 0;  // bits held; zero bits at their low end that are not data
    bool at_marker = false, overrun = false;

    void fill() {
        while (nbits <= 56) {
            uint64_t b = 0;
            if (!at_marker && pos < n) {
                b = d[pos];
                if (b == 0xFF) {
                    if (pos + 1 < n && d[pos + 1] == 0x00) {
                        pos += 2;
                    } else {
                        at_marker = true;
                        b = 0;
                        pad += 8;
                    }
                } else {
                    ++pos;
                }
            } else {
                pad += 8;
            }
            acc |= b << (56 - nbits);
            nbits += 8;
        }
    }
    uint32_t peek(int k) const { return uint32_t(acc >> (64 - k)); }
    void skip(int k) {
        if (k > nbits - pad) overrun = true;
        acc <<= k;
        nbits -= k;
        pad = std::min(pad, nbits);
    }
    int bits(int k) {  // k in 1..16
        const int v = int(peek(k));
        skip(k);
        return v;
    }
    // the next restart marker RSTn, after the bits of this interval (libjpeg
    // drops what is left of the byte and any bytes before the marker)
    bool restart(int idx) {
        acc = 0;
        nbits = pad = 0;
        at_marker = false;
        while (pos + 1 < n) {
            if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF) break;
            pos += (d[pos] == 0xFF && d[pos + 1] == 0x00) ? 2 : 1;
        }
        if (pos + 1 >= n || d[pos + 1] != 0xD0 + idx) return false;
        pos += 2;
        return true;
    }
};

inline int decode(BitReader& br, const Huffman& h, bool& bad) {
    const uint32_t look = h.look[br.peek(kLookBits)];
    if (look) {
        br.skip(look >> 8);
        return look & 0xFF;
    }
    const uint32_t word = br.peek(16);
    for (int l = kLookBits + 1; l <= 16; ++l) {
        const int32_t code = int32_t(word >> (16 - l));
        if (code <= h.maxcode[l]) {
            br.skip(l);
            return h.vals[code + h.valoffset[l]];
        }
    }
    bad = true;
    return 0;
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (int(-1) * (1 << s)) + 1 : v; }

inline int ceil_div(int64_t a, int64_t b) { return int((a + b - 1) / b); }

struct Frame {
    int W, H, nc, hmax, vmax, mcux, mcuy;
    int h[4], v[4];
    int64_t offset[4];  // of each component's [bh][bw][64] coefficients

    explicit Frame(const int32_t* f) {
        W = f[0], H = f[1], nc = f[2];
        hmax = vmax = 1;
        for (int c = 0; c < nc; ++c) {
            h[c] = f[3 + 2 * c], v[c] = f[4 + 2 * c];
            hmax = std::max(hmax, h[c]);
            vmax = std::max(vmax, v[c]);
        }
        mcux = ceil_div(W, 8 * hmax);
        mcuy = ceil_div(H, 8 * vmax);
        int64_t off = 0;
        for (int c = 0; c < nc; ++c) {
            offset[c] = off;
            off += int64_t(bw(c)) * bh(c) * 64;
        }
    }
    int bw(int c) const { return mcux * h[c]; }
    int bh(int c) const { return mcuy * v[c]; }
};

// --- jidctint.c: jpeg_idct_islow -------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct RangeLimit {
    uint8_t t[1024];  // the post-IDCT table, indexed by (value & 1023)
    RangeLimit() {
        for (int i = 0; i < 1024; ++i) {
            const int x = (i < 512 ? i : i - 1024) + 128;
            t[i] = uint8_t(std::min(255, std::max(0, x)));
        }
    }
};
const RangeLimit kLimit;

// The even and odd parts shared by both passes: in[0..7] -> out[0..7] before
// the final descale (results scaled by 2^CONST_BITS).
inline void idct_1d(const int64_t* in, int64_t* out) {
    int64_t z2 = in[2], z3 = in[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (in[0] + in[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (in[0] - in[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = in[7], tmp1 = in[5], tmp2 = in[3], tmp3 = in[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    out[0] = tmp10 + tmp3, out[7] = tmp10 - tmp3;
    out[1] = tmp11 + tmp2, out[6] = tmp11 - tmp2;
    out[2] = tmp12 + tmp1, out[5] = tmp12 - tmp1;
    out[3] = tmp13 + tmp0, out[4] = tmp13 - tmp0;
}

// One block: coef (natural order) times quant, into out[8][stride]. A
// column or row whose AC terms are all zero takes jidctint.c's shortcut,
// which gives the full path's values.
void idct_islow(const int16_t* coef, const int32_t* quant, uint8_t* out, int64_t stride) {
    int32_t ws[64];
    int64_t in[8], res[8];
    for (int col = 0; col < 8; ++col) {
        bool ac = false;
        for (int r = 1; r < 8; ++r) ac |= coef[r * 8 + col] != 0;
        if (!ac) {
            const int32_t dc = int32_t((int64_t(coef[col]) * quant[col]) * (int64_t(1) << kPass1Bits));
            for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
            continue;
        }
        for (int r = 0; r < 8; ++r) in[r] = int64_t(coef[r * 8 + col]) * quant[r * 8 + col];
        idct_1d(in, res);
        for (int r = 0; r < 8; ++r) ws[r * 8 + col] = int32_t(descale(res[r], kConstBits - kPass1Bits));
    }
    for (int row = 0; row < 8; ++row) {
        const int32_t* w = ws + row * 8;
        uint8_t* o = out + row * stride;
        if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
            std::memset(o, kLimit.t[descale(w[0], kPass1Bits + 3) & 1023], 8);
            continue;
        }
        for (int c = 0; c < 8; ++c) in[c] = w[c];
        idct_1d(in, res);
        for (int c = 0; c < 8; ++c) o[c] = kLimit.t[descale(res[c], kConstBits + kPass1Bits + 3) & 1023];
    }
}

// --- jdsample.c: one component at the frame's full size ---------------------------

// in: [dh][stride] samples of which the first dw per row are the
// component's; out: [H][W].
void upsample(const uint8_t* in, int64_t stride, int dw, int dh, int hx, int vx, uint8_t* out, int W, int H) {
    std::vector<int> colsum(dw + 2);
    std::vector<uint8_t> wide(2 * int64_t(dw));
    for (int y = 0; y < H; ++y) {
        uint8_t* o = out + int64_t(y) * W;
        const int i = y / vx;
        const uint8_t* row = in + int64_t(i) * stride;
        if (hx == 1 && vx == 1) {
            std::memcpy(o, row, W);
        } else if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
            for (int j = 0; j < dw; ++j) {
                const int a = row[j] * 3, l = row[std::max(j - 1, 0)], r = row[std::min(j + 1, dw - 1)];
                wide[2 * j] = uint8_t((a + l + 1) >> 2);
                wide[2 * j + 1] = uint8_t((a + r + 2) >> 2);
            }
            std::memcpy(o, wide.data(), W);
        } else if (vx == 2 && (hx == 1 || (hx == 2 && dw > 2))) {
            // h1v2_fancy_upsample / h2v2_fancy_upsample: the nearer row 3/4, the
            // row above (even output rows) or below (odd) 1/4
            const bool below = y & 1;
            const uint8_t* nb = in + int64_t(below ? std::min(i + 1, dh - 1) : std::max(i - 1, 0)) * stride;
            if (hx == 1) {
                const int bias = below ? 2 : 1;
                for (int x = 0; x < W; ++x) o[x] = uint8_t((row[x] * 3 + nb[x] + bias) >> 2);
            } else {
                for (int j = 0; j < dw; ++j) colsum[j + 1] = row[j] * 3 + nb[j];
                colsum[0] = colsum[1];
                colsum[dw + 1] = colsum[dw];
                for (int j = 0; j < dw; ++j) {
                    const int c = colsum[j + 1] * 3;
                    wide[2 * j] = uint8_t((c + colsum[j] + 8) >> 4);
                    wide[2 * j + 1] = uint8_t((c + colsum[j + 2] + 7) >> 4);
                }
                std::memcpy(o, wide.data(), W);
            }
        } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
            for (int x = 0; x < W; ++x) o[x] = row[x / hx];
        }
    }
}

// --- jdcolor.c: build_ycc_rgb_table -------------------------------------------------

struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        constexpr int kScaleBits = 16;
        constexpr int64_t kHalf = int64_t(1) << (kScaleBits - 1);
        auto fix = [](double x) { return int64_t(x * (1 << kScaleBits) + 0.5); };
        for (int i = 0; i < 256; ++i) {
            const int64_t x = i - 128;
            cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScaleBits);
            cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScaleBits);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + kHalf;
        }
    }
};
const YccTables kYcc;

inline uint8_t clamp8(int x) { return uint8_t(std::min(255, std::max(0, x))); }

}  // namespace

extern "C" {

// Decode one scan's entropy-coded bytes into the coefficient planes.
// frame: width, height, component count, then (h, v) per component.
// scan: (component index, DC table id, AC table id) per scan component.
// huff: [8][16 + 256] DC tables 0-3, then AC tables 0-3 (counts, symbols).
// coefs: every component's [mcuy * v][mcux * h][64] int16 block plane, back
// to back, in natural order. Returns 0, 1 (data ran out: truncated), 2 (no
// Huffman code matches) or 3 (a restart marker is missing or out of order).
int64_t jpeg_decode_scan(const uint8_t* data, int64_t len, const int32_t* frame_desc, const int32_t* scan,
                         int32_t ns, const uint8_t* huff, int32_t restart_interval, int16_t* coefs) {
    const Frame fr(frame_desc);
    Huffman dc[4], ac[4];
    int comp[4], td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
        comp[i] = scan[3 * i], td[i] = scan[3 * i + 1], ta[i] = scan[3 * i + 2];
        dc[td[i]].build(huff + td[i] * 272);
        ac[ta[i]].build(huff + (4 + ta[i]) * 272);
    }
    // MCUs: one block of a lone component, or h x v blocks of each one
    int mcus_x = fr.mcux, mcus_y = fr.mcuy;
    if (ns == 1) {
        const int c = comp[0];
        mcus_x = ceil_div(int64_t(fr.W) * fr.h[c], 8 * fr.hmax);
        mcus_y = ceil_div(int64_t(fr.H) * fr.v[c], 8 * fr.vmax);
    }
    BitReader br{data, len};
    int pred[4] = {0, 0, 0, 0};
    bool bad = false;
    const int64_t total = int64_t(mcus_x) * mcus_y;
    for (int64_t m = 0; m < total; ++m) {
        if (restart_interval && m && m % restart_interval == 0) {
            if (br.overrun) return kTruncated;
            if (!br.restart(int((m / restart_interval - 1) & 7))) return kNoRestart;
            std::fill(pred, pred + 4, 0);
        }
        const int mx = int(m % mcus_x), my = int(m / mcus_x);
        for (int i = 0; i < ns; ++i) {
            const int c = comp[i];
            const int bh = ns == 1 ? 1 : fr.v[c], bwn = ns == 1 ? 1 : fr.h[c];
            for (int by = 0; by < bh; ++by) {
                for (int bx = 0; bx < bwn; ++bx) {
                    const int64_t row = int64_t(my) * bh + by, col = int64_t(mx) * bwn + bx;
                    int16_t* blk = coefs + fr.offset[c] + (row * fr.bw(c) + col) * 64;
                    br.fill();
                    int s = decode(br, dc[td[i]], bad);
                    if (s) s = extend(br.bits(s), s);
                    pred[i] += s;
                    blk[0] = int16_t(pred[i]);
                    for (int k = 1; k < 64; ++k) {
                        br.fill();
                        const int rs = decode(br, ac[ta[i]], bad);
                        const int r = rs >> 4;
                        s = rs & 15;
                        if (s) {
                            k += r;
                            blk[kNaturalOrder[k]] = int16_t(extend(br.bits(s), s));
                        } else if (r == 15) {
                            k += 15;
                        } else {
                            break;
                        }
                    }
                    if (bad) return kBadCode;
                }
            }
        }
    }
    return br.overrun ? kTruncated : kOk;
}

// The image of the decoded coefficients. quant: [components][64] natural
// order. ycc: 1 when three components are YCbCr (to RGB), 0 when they are
// RGB already or there is one. out: [H][W][components] uint8.
void jpeg_pixels(const int32_t* frame_desc, const int16_t* coefs, const int32_t* quant, int32_t ycc, uint8_t* out) {
    const Frame fr(frame_desc);
    const int64_t npix = int64_t(fr.W) * fr.H;
    std::vector<uint8_t> planes(npix * fr.nc);
    for (int c = 0; c < fr.nc; ++c) {
        const int bw = fr.bw(c), bh = fr.bh(c);
        const int64_t stride = int64_t(bw) * 8;
        std::vector<uint8_t> samples(stride * bh * 8);
        for (int by = 0; by < bh; ++by)
            for (int bx = 0; bx < bw; ++bx)
                idct_islow(coefs + fr.offset[c] + (int64_t(by) * bw + bx) * 64, quant + 64 * c,
                           samples.data() + int64_t(by) * 8 * stride + bx * 8, stride);
        const int dw = ceil_div(int64_t(fr.W) * fr.h[c], fr.hmax), dh = ceil_div(int64_t(fr.H) * fr.v[c], fr.vmax);
        upsample(samples.data(), stride, dw, dh, fr.hmax / fr.h[c], fr.vmax / fr.v[c], planes.data() + c * npix,
                 fr.W, fr.H);
    }
    if (fr.nc == 1) {
        std::memcpy(out, planes.data(), npix);
        return;
    }
    const uint8_t *p0 = planes.data(), *p1 = p0 + npix, *p2 = p1 + npix;
    for (int64_t i = 0; i < npix; ++i) {
        uint8_t* o = out + 3 * i;
        if (ycc) {
            const int y = p0[i], cb = p1[i], cr = p2[i];
            o[0] = clamp8(y + kYcc.cr_r[cr]);
            o[1] = clamp8(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
            o[2] = clamp8(y + kYcc.cb_b[cb]);
        } else {
            o[0] = p0[i], o[1] = p1[i], o[2] = p2[i];
        }
    }
}

}  // extern "C"
