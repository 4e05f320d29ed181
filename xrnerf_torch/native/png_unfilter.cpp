// PNG scanline unfiltering (PNG spec, section 9: filter method 0, types
// 0-4) for xrnerf_torch/utils/png.py. Average and Paeth predict each byte
// from the decoded byte to its left, so a row is one serial pass; in
// numpy that is a Python loop over the pixels.
//
// Build: g++ -O3 -shared -fPIC -o libpng_unfilter.so png_unfilter.cpp
// (native/__init__.py builds it into xrnerf_torch/_build/ on first use and
// binds it with ctypes).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// src: height rows of (1 + stride) bytes, each a filter-type byte and the
// row's filtered bytes; dst: height * stride bytes. bpp is the filter's
// byte distance (bytes per complete pixel, at least 1). Returns 0, or
// 1 + the index of the first row whose filter type is not 0-4.
int64_t png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height, int64_t stride, int64_t bpp) {
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* raw = src + y * (stride + 1) + 1;
        const int ft = src[y * (stride + 1)];
        uint8_t* out = dst + y * stride;
        const uint8_t* up = y > 0 ? out - stride : nullptr;
        switch (ft) {
            case 0:
                std::memcpy(out, raw, stride);
                break;
            case 1:
                for (int64_t x = 0; x < stride; ++x)
                    out[x] = uint8_t(raw[x] + (x >= bpp ? out[x - bpp] : 0));
                break;
            case 2:
                for (int64_t x = 0; x < stride; ++x)
                    out[x] = uint8_t(raw[x] + (up ? up[x] : 0));
                break;
            case 3:
                for (int64_t x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? out[x - bpp] : 0;
                    const int b = up ? up[x] : 0;
                    out[x] = uint8_t(raw[x] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? out[x - bpp] : 0;
                    const int b = up ? up[x] : 0;
                    const int c = (up && x >= bpp) ? up[x - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    out[x] = uint8_t(raw[x] + pred);
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}

}  // extern "C"
