// BVH traversal kernels for Hopper (sm_90a): closest hit, closest hit
// with the interaction fill, and any hit, over the compact wide rows.
//
// Replaces the TPU kernels of pnraytracing_tpu/accel/traverse_pallas.py:
//   closest_hit_kernel<true>   <- _closest_kernel_wide_attr
//   closest_hit_kernel<false>  <- _closest_kernel_wide (the same template
//                                 with the attribute stores compiled out)
//   any_hit_kernel             <- _any_kernel_wide
//
// Design.  One thread per ray, each with its own stack of KSTACK ints.
// The Pallas kernels walk one SHARED stack per 128-lane ray tile, because
// Mosaic cannot index a different node per lane; Hopper can, so the tile
// stack and its per-tile direction signs / axis flags are gone.  The walk
// is push-test: popping an internal row slab-tests BOTH children against
// the ray's current t and pushes the hit ones, far child first, so the
// near child (by this ray's own direction sign on the row's split axis)
// pops next; popping a leaf runs only its triangle tests.  The scene
// (nodes16c [N,16], tri9 [T,9], tri_attr16 [T,16] f32) stays in global
// memory: at ~0.75 MB for the flagship teapot it lives in the 50 MB L2.
// Node and attribute rows are read as four float4 through __ldg.
//
// Arithmetic.  Op for op the component forms of ops/intersect.py
// (triangle_setup_c, intersect_triangle_c, intersect_aabb_c).  This file
// MUST be compiled with --fmad=false: an FMA shifts t by ~1 ulp, and at
// t_scaled == t_max * det that flips a hit, so the plain PyTorch version
// (accel/traverse_cuda.py) would no longer give the same t, tri and b.
// Divisions are IEEE (no fast math).  A later PR may trade this for speed.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): bytes = the ray
// inputs (8 words) and outputs (4 or 10 words, plus stats) per ray; work
// = the counted AABB tests (2 per internal pop, ~25 flops each) and
// triangle tests (~50 flops each) that the per-ray stats output reports.
// Both bounds are a few microseconds at the flagship's 262k rays, far
// below the measured time (PERF.md).  The expected limiter of this design is
// warp divergence: the 32 rays of a warp walk different paths, so a warp
// runs as long as its longest ray and idles lanes at every branch.  That
// is left to a later PR (ray sorting is already done by the integrator;
// a persistent work-stealing loop or a wider BVH are the next steps).

#include <cuda_runtime.h>
#include <stdint.h>

#define KSTACK 64

namespace {

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float inv_dx, inv_dy, inv_dz;
  // watertight setup: axis permutation + shear constants
  int kx, ky, kz;
  float sx, sy, sz;
};

__device__ __forceinline__ float sel3(int k, float x, float y, float z) {
  return k == 0 ? x : (k == 1 ? y : z);
}

__device__ __forceinline__ float safe_inv(float d) {
  return (d >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d), 1e-20f);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.inv_dx = safe_inv(dx);
  r.inv_dy = safe_inv(dy);
  r.inv_dz = safe_inv(dz);
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  // argmax |d|, first index among maxima (jnp.argmax tie-breaking)
  r.kz = adx >= ady ? (adx >= adz ? 0 : 2) : (ady >= adz ? 1 : 2);
  r.kx = (r.kz + 1) % 3;
  r.ky = (r.kx + 1) % 3;
  r.sz = 1.0f / sel3(r.kz, dx, dy, dz);
  r.sx = sel3(r.kx, dx, dy, dz) * r.sz;
  r.sy = sel3(r.ky, dx, dy, dz) * r.sz;
  return r;
}

// Slab test clipped to [0, t_max] (intersect_aabb_c).
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
  return (t1 >= fmaxf(t0, 0.0f)) && (t0 <= t_max);
}

// Watertight ray-triangle test (intersect_triangle_c).
__device__ __forceinline__ bool hit_triangle(const Ray& r,
                                             const float* __restrict__ tri9,
                                             int ti, float t_max, float& t,
                                             float& b1, float& b2) {
  const float* p = tri9 + 9 * (int64_t)ti;
  const float p0x = __ldg(p + 0) - r.ox, p0y = __ldg(p + 1) - r.oy,
              p0z = __ldg(p + 2) - r.oz;
  const float p1x = __ldg(p + 3) - r.ox, p1y = __ldg(p + 4) - r.oy,
              p1z = __ldg(p + 5) - r.oz;
  const float p2x = __ldg(p + 6) - r.ox, p2y = __ldg(p + 7) - r.oy,
              p2z = __ldg(p + 8) - r.oz;
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

struct Row {
  float lmn[3], lmx[3], rmn[3], rmx[3];
  int li, ri, axis;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ nodes,
                                        int row) {
  const float4* q = reinterpret_cast<const float4*>(nodes) + 4 * (int64_t)row;
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2),
               d = __ldg(q + 3);
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

// Push the hit children of an internal row, far first (near pops next).
__device__ __forceinline__ void push_children(const Ray& r, const Row& w,
                                              float t, int* stack, int& top) {
  const bool hl = hit_aabb(r, w.lmn[0], w.lmn[1], w.lmn[2], w.lmx[0],
                           w.lmx[1], w.lmx[2], t);
  const bool hr = hit_aabb(r, w.rmn[0], w.rmn[1], w.rmn[2], w.rmx[0],
                           w.rmx[1], w.rmx[2], t);
  const bool d_neg = sel3(w.axis, r.dx, r.dy, r.dz) < 0.0f;
  const int near_c = d_neg ? w.ri : w.li;
  const int far_c = d_neg ? w.li : w.ri;
  const bool h_near = d_neg ? hr : hl;
  const bool h_far = d_neg ? hl : hr;
  if (h_far) stack[top++] = far_c;
  if (h_near) stack[top++] = near_c;
}

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *t_max;
  const uint8_t* mask;  // null: every ray active
  int n;
};

template <bool ATTR>
__global__ void __launch_bounds__(128)
closest_hit_kernel(const float* __restrict__ nodes,
                   const float* __restrict__ tri9,
                   const float* __restrict__ attr16, Rays rays,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   float* __restrict__ b1_out, float* __restrict__ b2_out,
                   float* __restrict__ nx_out, float* __restrict__ ny_out,
                   float* __restrict__ nz_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ mt_out,
                   int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = make_ray(rays.ox[i], rays.oy[i], rays.oz[i], rays.dx[i],
                         rays.dy[i], rays.dz[i]);
  const bool active = rays.mask == nullptr || rays.mask[i] != 0;
  float t_best = rays.t_max[i];
  int tri_best = -1;
  float b1_best = 0.0f, b2_best = 0.0f;
  // miss defaults of the attribute outputs: normal +z, uv 0, word 0
  float nx_b = 0.0f, ny_b = 0.0f, nz_b = 1.0f, u_b = 0.0f, v_b = 0.0f;
  int mt_b = 0;
  int pops = 0, leaf_pops = 0, tri_tests = 0;

  int stack[KSTACK];
  int top = 0;
  if (active) stack[top++] = 0;  // root row
  while (top > 0) {
    const int info = stack[--top];
    ++pops;
    if (info < 0) {
      ++leaf_pops;
      const int meta = -info - 1;
      const int start = meta >> 4;
      const int count = meta & 15;
      tri_tests += count;
      for (int k = 0; k < count; ++k) {
        const int ti = start + k;
        float t, b1, b2;
        if (hit_triangle(r, tri9, ti, t_best, t, b1, b2) && t < t_best) {
          t_best = t;
          tri_best = ti;
          b1_best = b1;
          b2_best = b2;
          if (ATTR) {
            // interpolate with THIS test's barycentrics (b0 = 1 - b1 - b2)
            const float b0 = 1.0f - b1 - b2;
            const float4* q =
                reinterpret_cast<const float4*>(attr16) + 4 * (int64_t)ti;
            const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2),
                         d = __ldg(q + 3);
            nx_b = a.x * b0 + a.w * b1 + b.z * b2;
            ny_b = a.y * b0 + b.x * b1 + b.w * b2;
            nz_b = a.z * b0 + b.y * b1 + c.x * b2;
            u_b = c.y * b0 + c.w * b1 + d.y * b2;
            v_b = c.z * b0 + d.x * b1 + d.z * b2;
            mt_b = (int)d.w;
          }
        }
      }
    } else {
      push_children(r, load_row(nodes, info), t_best, stack, top);
    }
  }
  t_out[i] = t_best;
  tri_out[i] = tri_best;
  b1_out[i] = b1_best;
  b2_out[i] = b2_best;
  if (ATTR) {
    nx_out[i] = nx_b;
    ny_out[i] = ny_b;
    nz_out[i] = nz_b;
    u_out[i] = u_b;
    v_out[i] = v_b;
    mt_out[i] = mt_b;
  }
  if (stats != nullptr) {
    stats[i] = pops;
    stats[rays.n + i] = leaf_pops;
    stats[2 * rays.n + i] = tri_tests;
  }
}

__global__ void __launch_bounds__(128)
any_hit_kernel(const float* __restrict__ nodes, const float* __restrict__ tri9,
               Rays rays, uint8_t* __restrict__ occ_out,
               int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = make_ray(rays.ox[i], rays.oy[i], rays.oz[i], rays.dx[i],
                         rays.dy[i], rays.dz[i]);
  const bool active = rays.mask == nullptr || rays.mask[i] != 0;
  const float t_max = rays.t_max[i];
  bool occ = false;
  int pops = 0, leaf_pops = 0, tri_tests = 0;

  int stack[KSTACK];
  int top = 0;
  if (active) stack[top++] = 0;
  while (top > 0 && !occ) {
    const int info = stack[--top];
    ++pops;
    if (info < 0) {
      ++leaf_pops;
      const int meta = -info - 1;
      const int start = meta >> 4;
      const int count = meta & 15;
      for (int k = 0; k < count; ++k) {
        float t, b1, b2;
        ++tri_tests;
        if (hit_triangle(r, tri9, start + k, t_max, t, b1, b2)) {
          occ = true;  // occluded: stop at once
          break;
        }
      }
    } else {
      push_children(r, load_row(nodes, info), t_max, stack, top);
    }
  }
  occ_out[i] = occ ? 1 : 0;
  if (stats != nullptr) {
    stats[i] = pops;
    stats[rays.n + i] = leaf_pops;
    stats[2 * rays.n + i] = tri_tests;
  }
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

constexpr int kThreads = 128;

}  // namespace

extern "C" {

// Closest hit; with attr != 0 also the interaction fill (nx..mt must then
// be non-null).  stats may be null, else [3, n] int32: pops, leaf pops,
// triangle tests.  Returns cudaGetLastError() after the launch.
int pnrt_closest_hit(const float* nodes, const float* tri9,
                     const float* attr16, const float* ox, const float* oy,
                     const float* oz, const float* dx, const float* dy,
                     const float* dz, const float* t_max,
                     const uint8_t* mask, int n, int attr, float* t_out,
                     int* tri_out, float* b1_out, float* b2_out,
                     float* nx_out, float* ny_out, float* nz_out,
                     float* u_out, float* v_out, int* mt_out, int* stats,
                     void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (attr) {
    closest_hit_kernel<true><<<blocks, kThreads, 0, s>>>(
        nodes, tri9, attr16, rays, t_out, tri_out, b1_out, b2_out, nx_out,
        ny_out, nz_out, u_out, v_out, mt_out, stats);
  } else {
    closest_hit_kernel<false><<<blocks, kThreads, 0, s>>>(
        nodes, tri9, nullptr, rays, t_out, tri_out, b1_out, b2_out, nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr, stats);
  }
  return (int)cudaGetLastError();
}

int pnrt_any_hit(const float* nodes, const float* tri9, const float* ox,
                 const float* oy, const float* oz, const float* dx,
                 const float* dy, const float* dz, const float* t_max,
                 const uint8_t* mask, int n, uint8_t* occ_out, int* stats,
                 void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  const int blocks = (n + kThreads - 1) / kThreads;
  any_hit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, tri9, rays, occ_out, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
