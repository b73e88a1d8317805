// Device-side ray setup, slab test, watertight triangle test and wide-row
// walk steps shared by traverse.cu and traverse_stream.cu.
//
// Compat mode.  The ray setup and the slab test take a compile-time
// COMPAT parameter, and so does every walk step that calls them: with
// COMPAT the reference's quirks (RenderConfig.compat_pnrt of both
// packages; pnraytracing_tpu/ops/intersect.py:46-61, 129-160, 250-282):
// the watertight test permutes its axes only when d.z == 0, and the slab
// test is the interval-free t1 >= t0, so a walk prunes no box by its t.
// Each kernel is instantiated for both values; COMPAT == false compiles to
// the code it had before the parameter existed.
//
// Arithmetic.  Op for op the component forms of ops/intersect.py
// (triangle_setup_c, intersect_triangle_c, intersect_aabb_c).  Every file
// that includes this one MUST be compiled with --fmad=false: an FMA
// shifts t by ~1 ulp, and at t_scaled == t_max * det that flips a hit, so
// the plain PyTorch versions (accel/traverse_cuda.py,
// accel/traverse_stream_cuda.py) would no longer give the same t, tri and
// b.  Divisions are IEEE (no fast math).
//
// Loads.  Every table (wide rows, triangles, brick blobs) lies in device
// memory and is read through __ldg, the read-only path; wide rows as four
// float4, padded triangle rows (tri12) as three, tri9 rows word by word.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define KSTACK 64

namespace pnrt {

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float inv_dx, inv_dy, inv_dz;
  // watertight setup: axis permutation + shear constants
  int kx, ky, kz;
  float sx, sy, sz;
};

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }

__device__ __forceinline__ float4 ldf4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float sel3(int k, float x, float y, float z) {
  return k == 0 ? x : (k == 1 ? y : z);
}

__device__ __forceinline__ float safe_inv(float d) {
  return (d >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d), 1e-20f);
}

template <bool COMPAT>
__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.inv_dx = safe_inv(dx);
  r.inv_dy = safe_inv(dy);
  r.inv_dz = safe_inv(dz);
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  if constexpr (COMPAT) {
    // (x, y, z) unless d.z == 0 (also -0); then (z, y, x) where |dx| >
    // |dy|, else (x, z, y) (triangle.hpp:34-47).  A tiny nonzero d.z
    // keeps kz = 2: its 1 / d.z may be inf and the test's shears NaN,
    // which fail every comparison, as in the plain version.
    (void)adz;
    const bool z_zero = dz == 0.0f;
    const bool zx = adx > ady;
    r.kx = z_zero ? (zx ? 2 : 0) : 0;
    r.ky = z_zero ? (zx ? 1 : 2) : 1;
    r.kz = z_zero ? (zx ? 0 : 1) : 2;
  } else {
    // argmax |d|, first index among maxima (jnp.argmax tie-breaking)
    r.kz = adx >= ady ? (adx >= adz ? 0 : 2) : (ady >= adz ? 1 : 2);
    r.kx = (r.kz + 1) % 3;
    r.ky = (r.kx + 1) % 3;
  }
  r.sz = 1.0f / sel3(r.kz, dx, dy, dz);
  r.sx = sel3(r.kx, dx, dy, dz) * r.sz;
  r.sy = sel3(r.ky, dx, dy, dz) * r.sz;
  return r;
}

// True for a ray whose slab tests are NaN whatever the (finite) box: a
// NaN component of the origin or the direction, or an axis on which both
// are infinite ((box - o) * (1 / d) is then inf * 0); never_enters of
// ops/intersect.py.  fminf / fmaxf drop a NaN where torch.minimum /
// maximum keep it, so such a ray would walk otherwise than in the plain
// versions.  Every walk gives it no pop at all, as they do: it can hit no
// triangle either (its watertight test is NaN, and every comparison of
// it fails), so only its stats change.
__device__ __forceinline__ bool nan_axis(float o, float d) {
  return isnan(o) || isnan(d) || (isinf(o) && isinf(d));
}

__device__ __forceinline__ bool never_enters(const Ray& r) {
  return nan_axis(r.ox, r.dx) || nan_axis(r.oy, r.dy) ||
         nan_axis(r.oz, r.dz);
}

// Slab test clipped to [0, t_max] (intersect_aabb_c); with COMPAT the
// reference's t1 >= t0, which reads no t_max.
template <bool COMPAT>
__device__ __forceinline__ bool hit_aabb(const Ray& r, float mnx, float mny,
                                         float mnz, float mxx, float mxy,
                                         float mxz, float t_max) {
  const float fx = (mxx - r.ox) * r.inv_dx;
  const float nx = (mnx - r.ox) * r.inv_dx;
  const float fy = (mxy - r.oy) * r.inv_dy;
  const float ny = (mny - r.oy) * r.inv_dy;
  const float fz = (mxz - r.oz) * r.inv_dz;
  const float nz = (mnz - r.oz) * r.inv_dz;
  const float t1 = fminf(fminf(fmaxf(fx, nx), fmaxf(fy, ny)), fmaxf(fz, nz));
  const float t0 = fmaxf(fmaxf(fminf(fx, nx), fminf(fy, ny)), fminf(fz, nz));
  if constexpr (COMPAT) {
    (void)t_max;
    return t1 >= t0;
  } else {
    return (t1 >= fmaxf(t0, 0.0f)) && (t0 <= t_max);
  }
}

// Watertight ray-triangle test (intersect_triangle_c) of the triangle
// with corners v0, v1, v2.
__device__ __forceinline__ bool hit_corners(const Ray& r, float v0x,
                                            float v0y, float v0z, float v1x,
                                            float v1y, float v1z, float v2x,
                                            float v2y, float v2z, float t_max,
                                            float& t, float& b1, float& b2) {
  const float p0x = v0x - r.ox, p0y = v0y - r.oy, p0z = v0z - r.oz;
  const float p1x = v1x - r.ox, p1y = v1y - r.oy, p1z = v1z - r.oz;
  const float p2x = v2x - r.ox, p2y = v2y - r.oy, p2z = v2z - r.oz;
  const float a0 = sel3(r.kx, p0x, p0y, p0z), a1 = sel3(r.ky, p0x, p0y, p0z),
              a2 = sel3(r.kz, p0x, p0y, p0z);
  const float c0b = sel3(r.kx, p1x, p1y, p1z), c1b = sel3(r.ky, p1x, p1y, p1z),
              c2b = sel3(r.kz, p1x, p1y, p1z);
  const float c0 = sel3(r.kx, p2x, p2y, p2z), c1 = sel3(r.ky, p2x, p2y, p2z),
              c2 = sel3(r.kz, p2x, p2y, p2z);
  const float ax = a0 - a2 * r.sx;
  const float ay = a1 - a2 * r.sy;
  const float az = a2 * r.sz;
  const float bx = c0b - c2b * r.sx;
  const float by = c1b - c2b * r.sy;
  const float bz = c2b * r.sz;
  const float cx = c0 - c2 * r.sx;
  const float cy = c1 - c2 * r.sy;
  const float cz = c2 * r.sz;

  const float e0 = bx * cy - by * cx;
  const float e1 = cx * ay - cy * ax;
  const float e2 = ax * by - ay * bx;

  const bool any_neg = (e0 < 0.0f) || (e1 < 0.0f) || (e2 < 0.0f);
  const bool any_pos = (e0 > 0.0f) || (e1 > 0.0f) || (e2 > 0.0f);
  const float det = e0 + e1 + e2;
  const float t_scaled = e0 * az + e1 * bz + e2 * cz;
  const bool ok_pos = (det > 0.0f) && (t_scaled > 0.0f) &&
                      (t_scaled <= t_max * det);
  const bool ok_neg = (det < 0.0f) && (t_scaled < 0.0f) &&
                      (t_scaled >= t_max * det);
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  t = t_scaled * inv_det;
  b1 = e1 * inv_det;
  b2 = e2 * inv_det;
  return !(any_neg && any_pos) && (det != 0.0f) && (ok_pos || ok_neg);
}

// The same test of the triangle whose nine corner words start at p (a
// tri9 row: 36 bytes, so nine scalar loads).
__device__ __forceinline__ bool hit_triangle(const Ray& r, const float* p,
                                             float t_max, float& t,
                                             float& b1, float& b2) {
  return hit_corners(r, ldf(p + 0), ldf(p + 1), ldf(p + 2), ldf(p + 3),
                     ldf(p + 4), ldf(p + 5), ldf(p + 6), ldf(p + 7),
                     ldf(p + 8), t_max, t, b1, b2);
}

// A padded triangle row [v0, v1, v2, 0, 0, 0] (tri12: 48 bytes, 16-byte
// aligned), read as three float4.
struct Tri {
  float4 a, b, c;
};

__device__ __forceinline__ Tri load_tri12(const float* p) {
  Tri v;
  v.a = ldf4(p);
  v.b = ldf4(p + 4);
  v.c = ldf4(p + 8);
  return v;
}

// The same test of a loaded tri12 row.
__device__ __forceinline__ bool hit_tri(const Ray& r, const Tri& v,
                                        float t_max, float& t, float& b1,
                                        float& b2) {
  return hit_corners(r, v.a.x, v.a.y, v.a.z, v.a.w, v.b.x, v.b.y, v.b.z,
                     v.b.w, v.c.x, t_max, t, b1, b2);
}

// One wide row [lmin(3), lmax(3), rmin(3), rmax(3), left, right, axis,
// pad] (accel/layout.py::pack_wide_nodes_compact, accel/bricks.py).
struct Row {
  float lmn[3], lmx[3], rmn[3], rmx[3];
  int li, ri, axis;
};

// The row whose sixteen words are the four float4 a, b, c, d.
__device__ __forceinline__ Row make_row(const float4& a, const float4& b,
                                        const float4& c, const float4& d) {
  Row w;
  w.lmn[0] = a.x; w.lmn[1] = a.y; w.lmn[2] = a.z;
  w.lmx[0] = a.w; w.lmx[1] = b.x; w.lmx[2] = b.y;
  w.rmn[0] = b.z; w.rmn[1] = b.w; w.rmn[2] = c.x;
  w.rmx[0] = c.y; w.rmx[1] = c.z; w.rmx[2] = c.w;
  w.li = (int)d.x;  // exact small-int floats; truncation is exact
  w.ri = (int)d.y;
  w.axis = (int)d.z;
  return w;
}

// The row starting at word p (16-byte aligned), as four float4.
__device__ __forceinline__ Row load_row(const float* p) {
  return make_row(ldf4(p), ldf4(p + 4), ldf4(p + 8), ldf4(p + 12));
}

// Slab-test both children of a wide row against t; returns the hit
// children as (near, far) by this ray's direction sign on the row's axis.
template <bool COMPAT>
__device__ __forceinline__ void order_children(const Ray& r, const Row& w,
                                               float t, int& near_c,
                                               int& far_c, bool& h_near,
                                               bool& h_far) {
  const bool hl = hit_aabb<COMPAT>(r, w.lmn[0], w.lmn[1], w.lmn[2], w.lmx[0],
                                   w.lmx[1], w.lmx[2], t);
  const bool hr = hit_aabb<COMPAT>(r, w.rmn[0], w.rmn[1], w.rmn[2], w.rmx[0],
                                   w.rmx[1], w.rmx[2], t);
  const bool d_neg = sel3(w.axis, r.dx, r.dy, r.dz) < 0.0f;
  near_c = d_neg ? w.ri : w.li;
  far_c = d_neg ? w.li : w.ri;
  h_near = d_neg ? hr : hl;
  h_far = d_neg ? hl : hr;
}

// Push the hit children of an internal row, far first (near pops next).
template <bool COMPAT>
__device__ __forceinline__ void push_children(const Ray& r, const Row& w,
                                              float t, int* stack, int& top) {
  int near_c, far_c;
  bool h_near, h_far;
  order_children<COMPAT>(r, w, t, near_c, far_c, h_near, h_far);
  if (h_far) stack[top++] = far_c;
  if (h_near) stack[top++] = near_c;
}

// The walk's next node after an internal row: the near child if the ray
// hits it (the far one, if hit too, is pushed), else the far child if
// hit, else the stack's top; kWalkDone when the stack is empty.  The
// order of visits is that of push_children followed by a pop.
constexpr int kWalkDone = INT_MIN;  // no row id and no leaf info

__device__ __forceinline__ int pop_node(const int* stack, int& top) {
  return top > 0 ? stack[--top] : kWalkDone;
}

template <bool COMPAT>
__device__ __forceinline__ int next_node(const Ray& r, const Row& w, float t,
                                         int* stack, int& top) {
  int near_c, far_c;
  bool h_near, h_far;
  order_children<COMPAT>(r, w, t, near_c, far_c, h_near, h_far);
  if (h_near && h_far) stack[top++] = far_c;
  if (h_near) return near_c;
  if (h_far) return far_c;
  return pop_node(stack, top);
}

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *t_max;
  const uint8_t* mask;  // null: every ray active
  int n;
};

// Whether ray i walks at all: not masked out, and not a ray that
// never_enters any box.
__device__ __forceinline__ bool walks(const Rays& rays, int i,
                                      const Ray& r) {
  return (rays.mask == nullptr || rays.mask[i] != 0) && !never_enters(r);
}

inline Rays make_rays(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* t_max, const uint8_t* mask, int n) {
  Rays r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.t_max = t_max;
  r.mask = mask;
  r.n = n;
  return r;
}

__device__ __forceinline__ void write_stats(int* stats, int n, int i,
                                            int pops, int leaf_pops,
                                            int tri_tests) {
  if (stats != nullptr) {
    stats[i] = pops;
    stats[n + i] = leaf_pops;
    stats[2 * n + i] = tri_tests;
  }
}

}  // namespace pnrt
