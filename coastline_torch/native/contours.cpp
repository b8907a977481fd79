// Native contour tracing + RDP simplification for hosts without cv2 (the
// port's copy of coastline/native/contours.cpp).
//
// Semantics are an EXACT reimplementation of the pure-Python fallback in
// coastline_torch/infer/contours.py (_moore_trace/_rdp), which mirrors the
// reference's cv2.findContours(RETR_EXTERNAL) + approxPolyDP stage
// (predict_coastline.py:583-618):
//   - components labeled with scipy.ndimage.label's default 4-connectivity,
//     numbered in raster-scan order of first encounter;
//   - per component, Moore-neighborhood boundary walk from the topmost-
//     leftmost pixel, clockwise neighbor order starting one past the
//     backtrack direction, capped at 4*npix+8 steps;
//   - Ramer-Douglas-Peucker keep-mask with integer cross-product distances
//     (first-index tie-break on the max, matching numpy argmax).
// Tests assert bit-identical output against the Python implementation
// (tests/test_torch_native.py); the loops that are slow in CPython run at
// native speed on scene-size masks. Pixel indices are int32: masks up to
// 2^31 pixels (a 10980^2 granule is 1.2e8).
//
// Built by coastline_torch/native/__init__.py:  g++ -O2 -shared -fPIC.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Contour {
    std::vector<int32_t> xy;  // x0,y0,x1,y1,...
};

struct TraceResult {
    std::vector<Contour> contours;
};

// 4-connectivity labeling, labels assigned in raster-scan order of first
// encounter (flood fill from each unvisited foreground pixel) — matches
// scipy.ndimage.label's default structure and numbering.
void label4(const uint8_t* mask, int h, int w, std::vector<int32_t>& labels,
            int& ncomp) {
    labels.assign((size_t)h * w, 0);
    ncomp = 0;
    std::vector<int32_t> stack;
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            size_t p = (size_t)y * w + x;
            if (!mask[p] || labels[p]) continue;
            ++ncomp;
            stack.clear();
            stack.push_back((int32_t)p);
            labels[p] = ncomp;
            while (!stack.empty()) {
                int32_t q = stack.back();
                stack.pop_back();
                int qy = q / w, qx = q % w;
                const int ny[4] = {qy - 1, qy + 1, qy, qy};
                const int nx[4] = {qx, qx, qx - 1, qx + 1};
                for (int k = 0; k < 4; ++k) {
                    if (ny[k] < 0 || ny[k] >= h || nx[k] < 0 || nx[k] >= w)
                        continue;
                    size_t r = (size_t)ny[k] * w + nx[k];
                    if (mask[r] && !labels[r]) {
                        labels[r] = ncomp;
                        stack.push_back((int32_t)r);
                    }
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// Trace all external component boundaries of a binary HxW mask (uint8,
// nonzero = foreground). Returns an opaque handle; query with
// trace_ncontours/trace_len/trace_copy, release with trace_free.
void* trace_new(const uint8_t* mask, int h, int w) {
    auto* res = new TraceResult();
    std::vector<int32_t> labels;
    int ncomp = 0;
    label4(mask, h, w, labels, ncomp);

    // per-component pixel counts and topmost-leftmost starts
    std::vector<int64_t> count((size_t)ncomp + 1, 0);
    std::vector<int32_t> sy((size_t)ncomp + 1, -1), sx((size_t)ncomp + 1, -1);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int32_t l = labels[(size_t)y * w + x];
            if (!l) continue;
            ++count[l];
            if (sy[l] < 0) { sy[l] = y; sx[l] = x; }  // raster order => min y, then min x
        }

    // Moore neighborhood, clockwise from N — same table as the Python impl.
    const int offy[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
    const int offx[8] = {0, 1, 1, 1, 0, -1, -1, -1};

    for (int comp = 1; comp <= ncomp; ++comp) {
        Contour c;
        int cy = sy[comp], cx = sx[comp];
        const int starty = cy, startx = cx;
        c.xy.push_back(cx);
        c.xy.push_back(cy);
        int prev_dir = 6;  // coming from the left
        int64_t cap = 4 * count[comp] + 8;
        for (int64_t step = 0; step < cap; ++step) {
            bool found = false;
            for (int k = 0; k < 8; ++k) {
                int d = (prev_dir + 1 + k) % 8;
                int ny = cy + offy[d], nx = cx + offx[d];
                if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
                if (labels[(size_t)ny * w + nx] == comp) {
                    cy = ny; cx = nx;
                    prev_dir = (d + 4) % 8;
                    found = true;
                    break;
                }
            }
            if (!found || (cy == starty && cx == startx)) break;
            c.xy.push_back(cx);
            c.xy.push_back(cy);
        }
        res->contours.push_back(std::move(c));
    }
    return res;
}

int trace_ncontours(void* handle) {
    return (int)((TraceResult*)handle)->contours.size();
}

// number of (x, y) points in contour i
int64_t trace_len(void* handle, int i) {
    return (int64_t)((TraceResult*)handle)->contours[(size_t)i].xy.size() / 2;
}

// copy contour i into out (int32, shape (len, 2), x then y per row)
void trace_copy(void* handle, int i, int32_t* out) {
    const auto& xy = ((TraceResult*)handle)->contours[(size_t)i].xy;
    std::memcpy(out, xy.data(), xy.size() * sizeof(int32_t));
}

void trace_free(void* handle) { delete (TraceResult*)handle; }

// Ramer-Douglas-Peucker keep-mask over n int32 (x, y) points.
// Bit-identical to contours.py _rdp: integer cross products (exact in
// int64), perpendicular distance d = |cross| / |seg|, zero-length segments
// fall back to point distance, argmax takes the FIRST maximal index, and
// the segment survives when d[i] > eps strictly.
void rdp_keep(const int32_t* pts, int64_t n, double eps, uint8_t* keep) {
    std::memset(keep, 0, (size_t)n);
    if (n == 0) return;
    keep[0] = 1;
    keep[n - 1] = 1;
    if (n < 3) return;
    std::vector<std::pair<int64_t, int64_t>> stack;
    stack.emplace_back(0, n - 1);
    while (!stack.empty()) {
        auto [a, b] = stack.back();
        stack.pop_back();
        if (b <= a + 1) continue;
        int64_t segx = (int64_t)pts[2 * b] - pts[2 * a];
        int64_t segy = (int64_t)pts[2 * b + 1] - pts[2 * a + 1];
        double norm = std::hypot((double)segx, (double)segy);
        int64_t best_i = -1;
        double best_d = -1.0;
        for (int64_t j = a + 1; j < b; ++j) {
            int64_t dx = (int64_t)pts[2 * j] - pts[2 * a];
            int64_t dy = (int64_t)pts[2 * j + 1] - pts[2 * a + 1];
            double d;
            if (norm == 0.0) {
                d = std::hypot((double)dx, (double)dy);
            } else {
                int64_t cross = segx * dy - segy * dx;
                d = std::fabs((double)cross) / norm;
            }
            if (d > best_d) { best_d = d; best_i = j; }  // first max wins
        }
        if (best_d > eps) {
            keep[best_i] = 1;
            stack.emplace_back(a, best_i);
            stack.emplace_back(best_i, b);
        }
    }
}

}  // extern "C"
