// Uniform-grid mesh acceleration structure: nearest point on a mesh,
// inside/outside test, any-hit ray intersection — a copy of
// xrnerf_tpu/native/mesh_grid.cpp for the PyTorch port.
//
// Host-side counterpart of the reference's CUDA extension
// (extensions/mesh_grid: insert_grid_surface, search_nearest_point,
// search_inside_mesh, search_intersect). The network's path uses the dense
// torch queries of ops/mesh.py; this library serves host-side work (dataset
// SMPL queries, mesh post-processing) where a grid walk beats brute force.
//
// Build: g++ -O3 -shared -fPIC -o libmesh_grid.so mesh_grid.cpp
// (native/__init__.py builds it into xrnerf_torch/_build/ on first use and
// binds it with ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 add(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline Vec3 mul(Vec3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline Vec3 cross(Vec3 a, Vec3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float norm2(Vec3 a) { return dot(a, a); }

// Ericson RTCD 5.1.5: closest point on triangle abc to p.
static Vec3 closest_on_tri(Vec3 p, Vec3 a, Vec3 b, Vec3 c) {
    Vec3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
    float d1 = dot(ab, ap), d2 = dot(ac, ap);
    if (d1 <= 0 && d2 <= 0) return a;
    Vec3 bp = sub(p, b);
    float d3 = dot(ab, bp), d4 = dot(ac, bp);
    if (d3 >= 0 && d4 <= d3) return b;
    float vc = d1 * d4 - d3 * d2;
    if (vc <= 0 && d1 >= 0 && d3 <= 0) return add(a, mul(ab, d1 / (d1 - d3)));
    Vec3 cp = sub(p, c);
    float d5 = dot(ab, cp), d6 = dot(ac, cp);
    if (d6 >= 0 && d5 <= d6) return c;
    float vb = d5 * d2 - d1 * d6;
    if (vb <= 0 && d2 >= 0 && d6 <= 0) return add(a, mul(ac, d2 / (d2 - d6)));
    float va = d3 * d6 - d5 * d4;
    if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
        float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
        return add(b, mul(sub(c, b), w));
    }
    float denom = 1.0f / (va + vb + vc);
    return add(a, add(mul(ab, vb * denom), mul(ac, vc * denom)));
}

// Moeller-Trumbore; returns t or -1.
static float ray_tri(Vec3 o, Vec3 d, Vec3 a, Vec3 b, Vec3 c) {
    Vec3 e1 = sub(b, a), e2 = sub(c, a);
    Vec3 pvec = cross(d, e2);
    float det = dot(e1, pvec);
    if (std::fabs(det) < 1e-12f) return -1.0f;
    float inv = 1.0f / det;
    Vec3 tvec = sub(o, a);
    float u = dot(tvec, pvec) * inv;
    if (u < 0 || u > 1) return -1.0f;
    Vec3 qvec = cross(tvec, e1);
    float v = dot(d, qvec) * inv;
    if (v < 0 || u + v > 1) return -1.0f;
    float t = dot(e2, qvec) * inv;
    return t > 1e-6f ? t : -1.0f;
}

struct MeshGrid {
    std::vector<Vec3> verts;
    std::vector<int> faces;  // 3*n_faces
    int res;
    Vec3 bmin, bmax, cell;
    // CSR triangle lists per cell
    std::vector<int> cell_start;
    std::vector<int> cell_tris;

    int cell_of(int i, int j, int k) const { return (i * res + j) * res + k; }

    int clampi(int v) const { return std::max(0, std::min(res - 1, v)); }

    void coord_cell(Vec3 p, int& i, int& j, int& k) const {
        i = clampi((int)std::floor((p.x - bmin.x) / cell.x));
        j = clampi((int)std::floor((p.y - bmin.y) / cell.y));
        k = clampi((int)std::floor((p.z - bmin.z) / cell.z));
    }
};

}  // namespace

extern "C" {

void* mg_create(const float* verts, int n_verts, const int* faces, int n_faces,
                int res) {
    MeshGrid* g = new MeshGrid();
    g->res = res;
    g->verts.resize(n_verts);
    std::memcpy(g->verts.data(), verts, sizeof(float) * 3 * n_verts);
    g->faces.assign(faces, faces + 3 * n_faces);

    Vec3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    for (auto& v : g->verts) {
        lo = {std::min(lo.x, v.x), std::min(lo.y, v.y), std::min(lo.z, v.z)};
        hi = {std::max(hi.x, v.x), std::max(hi.y, v.y), std::max(hi.z, v.z)};
    }
    // pad so boundary triangles land strictly inside
    Vec3 pad = {(hi.x - lo.x) * 0.01f + 1e-5f, (hi.y - lo.y) * 0.01f + 1e-5f,
                (hi.z - lo.z) * 0.01f + 1e-5f};
    g->bmin = sub(lo, pad);
    g->bmax = add(hi, pad);
    g->cell = {(g->bmax.x - g->bmin.x) / res, (g->bmax.y - g->bmin.y) / res,
               (g->bmax.z - g->bmin.z) / res};

    // bin triangles by AABB overlap (insert_grid_surface semantics)
    int n_cells = res * res * res;
    std::vector<std::vector<int>> bins(n_cells);
    for (int t = 0; t < n_faces; ++t) {
        Vec3 a = g->verts[g->faces[3 * t]];
        Vec3 b = g->verts[g->faces[3 * t + 1]];
        Vec3 c = g->verts[g->faces[3 * t + 2]];
        Vec3 tlo = {std::min({a.x, b.x, c.x}), std::min({a.y, b.y, c.y}),
                    std::min({a.z, b.z, c.z})};
        Vec3 thi = {std::max({a.x, b.x, c.x}), std::max({a.y, b.y, c.y}),
                    std::max({a.z, b.z, c.z})};
        int i0, j0, k0, i1, j1, k1;
        g->coord_cell(tlo, i0, j0, k0);
        g->coord_cell(thi, i1, j1, k1);
        for (int i = i0; i <= i1; ++i)
            for (int j = j0; j <= j1; ++j)
                for (int k = k0; k <= k1; ++k) bins[g->cell_of(i, j, k)].push_back(t);
    }
    g->cell_start.resize(n_cells + 1, 0);
    for (int c = 0; c < n_cells; ++c)
        g->cell_start[c + 1] = g->cell_start[c] + (int)bins[c].size();
    g->cell_tris.resize(g->cell_start[n_cells]);
    for (int c = 0; c < n_cells; ++c)
        std::copy(bins[c].begin(), bins[c].end(),
                  g->cell_tris.begin() + g->cell_start[c]);
    return g;
}

void mg_destroy(void* h) { delete (MeshGrid*)h; }

// Nearest point on mesh per query: expanding-ring search over grid cells.
void mg_nearest(void* h, const float* pts, int n, float* out_pts, int* out_idx,
                float* out_dist) {
    MeshGrid* g = (MeshGrid*)h;
    float max_cell =
        std::max({g->cell.x, g->cell.y, g->cell.z});
    for (int q = 0; q < n; ++q) {
        Vec3 p = {pts[3 * q], pts[3 * q + 1], pts[3 * q + 2]};
        int ci, cj, ck;
        g->coord_cell(p, ci, cj, ck);
        float best_d2 = std::numeric_limits<float>::max();
        Vec3 best_p = p;
        int best_t = -1;
        for (int ring = 0; ring < g->res; ++ring) {
            // once a hit exists and the ring's nearest possible distance
            // exceeds it, stop
            if (best_t >= 0) {
                float ring_min = (ring - 1) * max_cell;
                if (ring_min > 0 && ring_min * ring_min > best_d2) break;
            }
            int i0 = std::max(0, ci - ring), i1 = std::min(g->res - 1, ci + ring);
            int j0 = std::max(0, cj - ring), j1 = std::min(g->res - 1, cj + ring);
            int k0 = std::max(0, ck - ring), k1 = std::min(g->res - 1, ck + ring);
            for (int i = i0; i <= i1; ++i)
                for (int j = j0; j <= j1; ++j)
                    for (int k = k0; k <= k1; ++k) {
                        // shell only
                        if (ring > 0 && i != i0 && i != i1 && j != j0 &&
                            j != j1 && k != k0 && k != k1)
                            continue;
                        int c = g->cell_of(i, j, k);
                        for (int s = g->cell_start[c]; s < g->cell_start[c + 1];
                             ++s) {
                            int t = g->cell_tris[s];
                            Vec3 cp = closest_on_tri(
                                p, g->verts[g->faces[3 * t]],
                                g->verts[g->faces[3 * t + 1]],
                                g->verts[g->faces[3 * t + 2]]);
                            float d2 = norm2(sub(p, cp));
                            if (d2 < best_d2) {
                                best_d2 = d2;
                                best_p = cp;
                                best_t = t;
                            }
                        }
                    }
            if (ring == g->res - 1) break;
        }
        out_pts[3 * q] = best_p.x;
        out_pts[3 * q + 1] = best_p.y;
        out_pts[3 * q + 2] = best_p.z;
        out_idx[q] = best_t;
        out_dist[q] = std::sqrt(best_d2);
    }
}

// Inside test: crossing parity along +x using the grid walk
// (search_inside_mesh semantics). out_sign: +1 inside, -1 outside.
void mg_inside(void* h, const float* pts, int n, float* out_sign) {
    MeshGrid* g = (MeshGrid*)h;
    Vec3 dir = {1.0f, 0.0f, 0.0f};
    for (int q = 0; q < n; ++q) {
        Vec3 p = {pts[3 * q], pts[3 * q + 1], pts[3 * q + 2]};
        if (p.x < g->bmin.x || p.x > g->bmax.x || p.y < g->bmin.y ||
            p.y > g->bmax.y || p.z < g->bmin.z || p.z > g->bmax.z) {
            out_sign[q] = -1.0f;
            continue;
        }
        int ci, cj, ck;
        g->coord_cell(p, ci, cj, ck);
        // gather candidate triangles from all +x cells in the row; count
        // distinct crossings by t to avoid double counting shared bins
        std::vector<float> ts;
        for (int i = ci; i < g->res; ++i) {
            int c = g->cell_of(i, cj, ck);
            for (int s = g->cell_start[c]; s < g->cell_start[c + 1]; ++s) {
                int t = g->cell_tris[s];
                float hit = ray_tri(p, dir, g->verts[g->faces[3 * t]],
                                    g->verts[g->faces[3 * t + 1]],
                                    g->verts[g->faces[3 * t + 2]]);
                if (hit > 0) ts.push_back(hit);
            }
        }
        std::sort(ts.begin(), ts.end());
        int crossings = 0;
        float last = -1.0f;
        for (float t : ts) {
            if (t - last > 1e-6f) {
                ++crossings;
                last = t;
            }
        }
        out_sign[q] = (crossings % 2 == 1) ? 1.0f : -1.0f;
    }
}

// Any-hit ray intersection with t in (0, t_max).
void mg_intersect(void* h, const float* origins, const float* dirs, int n,
                  const float* t_max, uint8_t* out_hit) {
    MeshGrid* g = (MeshGrid*)h;
    for (int q = 0; q < n; ++q) {
        Vec3 o = {origins[3 * q], origins[3 * q + 1], origins[3 * q + 2]};
        Vec3 d = {dirs[3 * q], dirs[3 * q + 1], dirs[3 * q + 2]};
        float tm = t_max[q];
        uint8_t hit = 0;
        // brute walk over all cells intersected is complex; since grids
        // are small (<=64^3) test cells along the ray in fixed steps of
        // half a cell
        float cell_min = std::min({g->cell.x, g->cell.y, g->cell.z});
        float dn = std::sqrt(norm2(d));
        float step = 0.5f * cell_min / (dn > 1e-12f ? dn : 1.0f);
        float span = std::sqrt(norm2(sub(g->bmax, g->bmin))) / (dn > 1e-12f ? dn : 1.0f);
        float t_end = std::min(tm, span * 2.0f);
        int last_cell = -1;
        for (float t = 0.0f; t <= t_end && !hit; t += step) {
            Vec3 p = add(o, mul(d, t));
            if (p.x < g->bmin.x || p.x > g->bmax.x || p.y < g->bmin.y ||
                p.y > g->bmax.y || p.z < g->bmin.z || p.z > g->bmax.z)
                continue;
            int i, j, k;
            g->coord_cell(p, i, j, k);
            int c = g->cell_of(i, j, k);
            if (c == last_cell) continue;
            last_cell = c;
            for (int s = g->cell_start[c]; s < g->cell_start[c + 1] && !hit; ++s) {
                int tr = g->cell_tris[s];
                float th = ray_tri(o, d, g->verts[g->faces[3 * tr]],
                                   g->verts[g->faces[3 * tr + 1]],
                                   g->verts[g->faces[3 * tr + 2]]);
                if (th > 0 && th < tm) hit = 1;
            }
        }
        out_hit[q] = hit;
    }
}

}  // extern "C"
