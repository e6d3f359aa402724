// Triangle BVH for SDF ground truth, ray tracing, and IoU oracles.
//
// C++ host-side equivalent of the reference's TriangleBvh
// (src/triangle_bvh.cu, include/.../triangle_bvh.cuh): median-split build
// on the widest centroid axis, iterative stack traversal, signed distance
// in Watertight (closest-triangle pseudo-normal) and Raystab (32
// Fibonacci-lattice stab rays, sign by any-escape) modes, and batched ray
// tracing. It runs on the host CPU: it labels SDF
// training batches and renders ground-truth references; all entry points
// are batched and multithreaded.
//
// Built as a shared library; Python binds via ctypes (no pybind11 in the
// image). All external entry points use the C ABI.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr float MAX_DIST = 10.0f;
constexpr float PI = 3.14159265358979323846f;

struct Vec3 {
    float x, y, z;

    Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
    Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    Vec3 operator*(float s) const { return {x * s, y * s, z * s}; }
    Vec3 operator/(float s) const { return {x / s, y / s, z / s}; }
};

inline float dot(const Vec3& a, const Vec3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline Vec3 cross(const Vec3& a, const Vec3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
inline float length(const Vec3& a) { return std::sqrt(dot(a, a)); }
inline Vec3 normalize(const Vec3& a) {
    float l = length(a);
    return l > 0 ? a / l : Vec3{0, 0, 0};
}
inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float clampf(float v, float lo, float hi) {
    return std::max(lo, std::min(hi, v));
}

struct Triangle {
    Vec3 a, b, c;

    Vec3 normal() const { return normalize(cross(b - a, c - a)); }
    Vec3 centroid() const { return (a + b + c) / 3.0f; }

    // Moller-Trumbore; returns t or MAX_DIST on miss.
    float ray_intersect(const Vec3& ro, const Vec3& rd) const {
        Vec3 e1 = b - a, e2 = c - a;
        Vec3 p = cross(rd, e2);
        float det = dot(e1, p);
        if (std::fabs(det) < 1e-12f) return MAX_DIST;
        float inv = 1.0f / det;
        Vec3 tv = ro - a;
        float u = dot(tv, p) * inv;
        if (u < 0.0f || u > 1.0f) return MAX_DIST;
        Vec3 q = cross(tv, e1);
        float v = dot(rd, q) * inv;
        if (v < 0.0f || u + v > 1.0f) return MAX_DIST;
        float t = dot(e2, q) * inv;
        return t > 1e-7f ? t : MAX_DIST;
    }

    Vec3 closest_point(const Vec3& p) const {
        // Ericson, Real-Time Collision Detection, 5.1.5
        Vec3 ab = b - a, ac = c - a, ap = p - a;
        float d1 = dot(ab, ap), d2 = dot(ac, ap);
        if (d1 <= 0 && d2 <= 0) return a;
        Vec3 bp = p - b;
        float d3 = dot(ab, bp), d4 = dot(ac, bp);
        if (d3 >= 0 && d4 <= d3) return b;
        float vc = d1 * d4 - d3 * d2;
        if (vc <= 0 && d1 >= 0 && d3 <= 0) return a + ab * (d1 / (d1 - d3));
        Vec3 cp = p - c;
        float d5 = dot(ab, cp), d6 = dot(ac, cp);
        if (d6 >= 0 && d5 <= d6) return c;
        float vb = d5 * d2 - d1 * d6;
        if (vb <= 0 && d2 >= 0 && d6 <= 0) return a + ac * (d2 / (d2 - d6));
        float va = d3 * d6 - d5 * d4;
        if (va <= 0 && d4 - d3 >= 0 && d5 - d6 >= 0) {
            return b + (c - b) * ((d4 - d3) / ((d4 - d3) + (d5 - d6)));
        }
        float denom = 1.0f / (va + vb + vc);
        return a + ab * (vb * denom) + ac * (vc * denom);
    }

    float distance_sq(const Vec3& p) const {
        Vec3 cp = closest_point(p);
        Vec3 d = p - cp;
        return dot(d, d);
    }
};

struct AABB {
    Vec3 lo{std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity()};
    Vec3 hi{-std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity()};

    void grow(const Vec3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
    void grow(const Triangle& t) { grow(t.a); grow(t.b); grow(t.c); }

    float distance_sq(const Vec3& p) const {
        float dx = std::max({lo.x - p.x, 0.0f, p.x - hi.x});
        float dy = std::max({lo.y - p.y, 0.0f, p.y - hi.y});
        float dz = std::max({lo.z - p.z, 0.0f, p.z - hi.z});
        return dx * dx + dy * dy + dz * dz;
    }

    // slab test; returns entry t or MAX_DIST
    float ray_intersect(const Vec3& ro, const Vec3& inv_rd) const {
        float t1 = (lo.x - ro.x) * inv_rd.x, t2 = (hi.x - ro.x) * inv_rd.x;
        float tmin = std::min(t1, t2), tmax = std::max(t1, t2);
        t1 = (lo.y - ro.y) * inv_rd.y; t2 = (hi.y - ro.y) * inv_rd.y;
        tmin = std::max(tmin, std::min(t1, t2));
        tmax = std::min(tmax, std::max(t1, t2));
        t1 = (lo.z - ro.z) * inv_rd.z; t2 = (hi.z - ro.z) * inv_rd.z;
        tmin = std::max(tmin, std::min(t1, t2));
        tmax = std::min(tmax, std::max(t1, t2));
        if (tmax < std::max(tmin, 0.0f)) return MAX_DIST;
        return std::max(tmin, 0.0f);
    }
};

struct Node {
    AABB bb;
    int32_t left;    // < 0: leaf, first tri = -left-1
    int32_t right;   // leaf: end tri = -right-1; inner: right child idx
};

struct Bvh {
    std::vector<Node> nodes;
    std::vector<Triangle> tris;

    void build(const float* tri_data, int n, int leaf_size) {
        tris.resize(n);
        std::memcpy(tris.data(), tri_data, sizeof(Triangle) * n);
        nodes.clear();
        nodes.reserve(2 * n / std::max(leaf_size, 1) + 2);
        build_range(0, n, leaf_size);
    }

    int build_range(int begin, int end, int leaf_size) {
        int idx = (int)nodes.size();
        nodes.push_back({});
        AABB bb;
        for (int i = begin; i < end; ++i) bb.grow(tris[i]);
        nodes[idx].bb = bb;
        if (end - begin <= leaf_size) {
            nodes[idx].left = -begin - 1;
            nodes[idx].right = -end - 1;
            return idx;
        }
        // median split on the widest centroid axis
        Vec3 ext = bb.hi - bb.lo;
        int axis = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2)
                                 : (ext.y > ext.z ? 1 : 2);
        int mid = (begin + end) / 2;
        std::nth_element(tris.begin() + begin, tris.begin() + mid,
                         tris.begin() + end,
                         [axis](const Triangle& t1, const Triangle& t2) {
                             auto key = [axis](const Triangle& t) {
                                 Vec3 c = t.centroid();
                                 return axis == 0 ? c.x
                                      : axis == 1 ? c.y : c.z;
                             };
                             return key(t1) < key(t2);
                         });
        int l = build_range(begin, mid, leaf_size);
        int r = build_range(mid, end, leaf_size);
        nodes[idx].left = l;
        nodes[idx].right = r;
        return idx;
    }

    std::pair<int, float> closest_triangle(const Vec3& p,
                                           float max_dist_sq) const {
        int stack[64];
        int sp = 0;
        stack[sp++] = 0;
        float best = max_dist_sq;
        int best_idx = -1;
        while (sp) {
            const Node& node = nodes[stack[--sp]];
            if (node.bb.distance_sq(p) > best) continue;
            if (node.left < 0) {
                for (int i = -node.left - 1; i < -node.right - 1; ++i) {
                    float d = tris[i].distance_sq(p);
                    if (d <= best) { best = d; best_idx = i; }
                }
            } else {
                // near child first
                float dl = nodes[node.left].bb.distance_sq(p);
                float dr = nodes[node.right].bb.distance_sq(p);
                int near = node.left, far = node.right;
                if (dr < dl) { std::swap(near, far); std::swap(dl, dr); }
                if (dr <= best) stack[sp++] = far;
                if (dl <= best) stack[sp++] = near;
            }
        }
        // nothing within the search radius: distance saturates at the
        // bound (returning 0 here would fake a surface hit far away)
        if (best_idx < 0) best_idx = 0;
        return {best_idx, std::sqrt(best)};
    }

    std::pair<int, float> ray_intersect(const Vec3& ro,
                                        const Vec3& rd) const {
        Vec3 inv{1.0f / (rd.x == 0 ? 1e-12f : rd.x),
                 1.0f / (rd.y == 0 ? 1e-12f : rd.y),
                 1.0f / (rd.z == 0 ? 1e-12f : rd.z)};
        int stack[64];
        int sp = 0;
        stack[sp++] = 0;
        float mint = MAX_DIST;
        int hit = -1;
        while (sp) {
            const Node& node = nodes[stack[--sp]];
            if (node.bb.ray_intersect(ro, inv) >= mint) continue;
            if (node.left < 0) {
                for (int i = -node.left - 1; i < -node.right - 1; ++i) {
                    float t = tris[i].ray_intersect(ro, rd);
                    if (t < mint) { mint = t; hit = i; }
                }
            } else {
                float dl = nodes[node.left].bb.ray_intersect(ro, inv);
                float dr = nodes[node.right].bb.ray_intersect(ro, inv);
                int near = node.left, far = node.right;
                if (dr < dl) { std::swap(near, far); std::swap(dl, dr); }
                if (dr < mint) stack[sp++] = far;
                if (dl < mint) stack[sp++] = near;
            }
        }
        return {hit, mint};
    }

    // average normal of triangles meeting at a surface point
    Vec3 avg_normal_around(const Vec3& p) const {
        constexpr float EPS = 1e-6f;
        int stack[64];
        int sp = 0;
        stack[sp++] = 0;
        Vec3 sum{0, 0, 0};
        while (sp) {
            const Node& node = nodes[stack[--sp]];
            if (node.bb.distance_sq(p) >= EPS) continue;
            if (node.left < 0) {
                for (int i = -node.left - 1; i < -node.right - 1; ++i) {
                    if (tris[i].distance_sq(p) < EPS) sum = sum + tris[i].normal();
                }
            } else {
                stack[sp++] = node.left;
                stack[sp++] = node.right;
            }
        }
        return sum;
    }

    float signed_distance_watertight(const Vec3& p) const {
        auto [idx, dist] = closest_triangle(p, MAX_DIST * MAX_DIST);
        Vec3 cp = tris[idx].closest_point(p);
        Vec3 n = avg_normal_around(cp);
        return std::copysign(dist, dot(n, p - cp));
    }

    float signed_distance_raystab(const Vec3& p, float off_x,
                                  float off_y) const {
        float dist = closest_triangle(p, MAX_DIST * MAX_DIST).second;
        constexpr int N_STAB = 32;
        for (int i = 0; i < N_STAB; ++i) {
            // Fibonacci lattice direction with random offset
            float eps = std::fmod(i + off_x, 1.0f);
            float z = 1.0f - 2.0f * eps;
            float r = std::sqrt(std::max(0.0f, 1.0f - z * z));
            float phi = 2.0f * PI * (i * 0.618033988749895f + off_y);
            Vec3 d{r * std::cos(phi), r * std::sin(phi), z};
            if (ray_intersect(p, d).first < 0) return dist;  // escaped
        }
        return -dist;
    }
};

void parallel_for(int n, const std::function<void(int, int)>& fn) {
    int n_threads = (int)std::thread::hardware_concurrency();
    n_threads = std::max(1, std::min(n_threads, n / 1024 + 1));
    if (n_threads <= 1) { fn(0, n); return; }
    std::vector<std::thread> workers;
    int chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int lo = t * chunk, hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        workers.emplace_back([=, &fn] { fn(lo, hi); });
    }
    for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

void* bvh_build(const float* triangles, int n_triangles, int leaf_size) {
    auto* bvh = new Bvh();
    bvh->build(triangles, n_triangles, leaf_size > 0 ? leaf_size : 4);
    return bvh;
}

void bvh_free(void* handle) { delete static_cast<Bvh*>(handle); }

int bvh_n_nodes(void* handle) {
    return (int)static_cast<Bvh*>(handle)->nodes.size();
}

// mode: 0 = watertight, 1 = raystab, 2 = unsigned
void bvh_signed_distance(void* handle, const float* positions, int n,
                         float* out, int mode, float off_x, float off_y) {
    auto* bvh = static_cast<Bvh*>(handle);
    parallel_for(n, [&](int lo, int hi) {
        for (int i = lo; i < hi; ++i) {
            Vec3 p{positions[i * 3], positions[i * 3 + 1],
                   positions[i * 3 + 2]};
            float d;
            if (mode == 0) d = bvh->signed_distance_watertight(p);
            else if (mode == 1) d = bvh->signed_distance_raystab(p, off_x, off_y);
            else d = bvh->closest_triangle(p, MAX_DIST * MAX_DIST).second;
            out[i] = d;
        }
    });
}

// outputs: t (n), tri index (n; -1 = miss)
void bvh_ray_trace(void* handle, const float* origins, const float* dirs,
                   int n, float* t_out, int* tri_out) {
    auto* bvh = static_cast<Bvh*>(handle);
    parallel_for(n, [&](int lo, int hi) {
        for (int i = lo; i < hi; ++i) {
            Vec3 o{origins[i * 3], origins[i * 3 + 1], origins[i * 3 + 2]};
            Vec3 d{dirs[i * 3], dirs[i * 3 + 1], dirs[i * 3 + 2]};
            auto [idx, t] = bvh->ray_intersect(o, d);
            t_out[i] = t;
            tri_out[i] = idx;
        }
    });
}

void bvh_closest_point(void* handle, const float* positions, int n,
                       float* out_points, int* out_tri) {
    auto* bvh = static_cast<Bvh*>(handle);
    parallel_for(n, [&](int lo, int hi) {
        for (int i = lo; i < hi; ++i) {
            Vec3 p{positions[i * 3], positions[i * 3 + 1],
                   positions[i * 3 + 2]};
            auto [idx, dist] = bvh->closest_triangle(p, MAX_DIST * MAX_DIST);
            Vec3 cp = bvh->tris[idx].closest_point(p);
            out_points[i * 3] = cp.x;
            out_points[i * 3 + 1] = cp.y;
            out_points[i * 3 + 2] = cp.z;
            out_tri[i] = idx;
        }
    });
}

}  // extern "C"
