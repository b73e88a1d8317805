// BVH traversal kernels for Hopper (sm_90a) over a scene resident in
// device memory: closest hit, closest hit with the interaction fill and
// any hit over the compact wide rows, and the binary pop-test walks.
//
// Replaces the TPU kernels of pnraytracing_tpu/accel/traverse_pallas.py:
//   closest_hit_kernel<true>   <- _closest_kernel_wide_attr
//   closest_hit_kernel<false>  <- _closest_kernel_wide (the same template
//                                 with the attribute stores compiled out)
//   any_hit_kernel             <- _any_kernel_wide
//   closest_hit_binary_kernel  <- _closest_kernel
//   any_hit_binary_kernel      <- _any_kernel
//
// Design.  One thread per ray, each with its own stack of KSTACK ints.
// The Pallas kernels walk one SHARED stack per 128-lane ray tile, because
// Mosaic cannot index a different node per lane; Hopper can, so the tile
// stack and its per-tile direction signs / axis flags are gone.  The wide
// walk is push-test: popping an internal row slab-tests BOTH children
// against the ray's current t and pushes the hit ones, far child first,
// so the near child (by this ray's own direction sign on the row's split
// axis) pops next; popping a leaf runs only its triangle tests.  The
// binary walk is pop-test over nodes8 [N, 8] rows (min, max,
// enc(right*4+axis), enc(start*16+count)): a popped node tests its own
// box, then either tests its leaf's triangles or pushes both children
// (left = node + 1), far first.  The scene (nodes16c [N,16] or nodes8
// [N,8], tri9 [T,9], tri_attr16 [T,16] f32) stays in device memory: at
// ~0.75 MB for the flagship teapot it lives in the 50 MB L2.  Rows are
// read as float4 through __ldg.  Arithmetic and --fmad=false: see
// intersect.cuh.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): bytes = the ray
// inputs (8 words) and outputs (4 or 10 words, plus stats) per ray; work
// = the counted AABB tests (2 per internal pop for the wide walk, 1 per
// pop for the binary walk, ~25 flops each) and triangle tests (~50 flops
// each) that the per-ray stats output reports.  Both bounds are a few
// microseconds at the flagship's 262k rays, far below the measured time
// (PERF.md).  The expected limiter of this design is warp divergence: the
// 32 rays of a warp walk different paths, so a warp runs as long as its
// longest ray and idles lanes at every branch.  That is left to a later
// PR (ray sorting is already done by the integrator; a persistent
// work-stealing loop or a wider BVH are the next steps).  The binary walk
// pops about twice as many nodes as the wide one for the same hits.

#include "intersect.cuh"

using namespace pnrt;

namespace {

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
        if (hit_triangle(r, tri9 + 9 * (int64_t)ti, t_best, t, b1,
                               b2) &&
            t < t_best) {
          t_best = t;
          tri_best = ti;
          b1_best = b1;
          b2_best = b2;
          if (ATTR) {
            // interpolate with THIS test's barycentrics (b0 = 1 - b1 - b2)
            const float b0 = 1.0f - b1 - b2;
            const float* q = attr16 + 16 * (int64_t)ti;
            const float4 a = ldf4(q), b = ldf4(q + 4),
                         c = ldf4(q + 8), d = ldf4(q + 12);
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
      push_children(r, load_row(nodes + 16 * (int64_t)info), t_best,
                    stack, top);
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
  write_stats(stats, rays.n, i, pops, leaf_pops, tri_tests);
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
        if (hit_triangle(r, tri9 + 9 * (int64_t)(start + k), t_max, t,
                               b1, b2)) {
          occ = true;  // occluded: stop at once
          break;
        }
      }
    } else {
      push_children(r, load_row(nodes + 16 * (int64_t)info), t_max,
                    stack, top);
    }
  }
  occ_out[i] = occ ? 1 : 0;
  write_stats(stats, rays.n, i, pops, leaf_pops, tri_tests);
}

// One binary node row: its box, and either its leaf range or its children.
struct Node8 {
  float mn[3], mx[3];
  int enc_right, meta;
};

__device__ __forceinline__ Node8 load_node8(const float* __restrict__ nodes8,
                                            int node) {
  const float* p = nodes8 + 8 * (int64_t)node;
  const float4 a = ldf4(p), b = ldf4(p + 4);
  Node8 w;
  w.mn[0] = a.x; w.mn[1] = a.y; w.mn[2] = a.z;
  w.mx[0] = a.w; w.mx[1] = b.x; w.mx[2] = b.y;
  w.enc_right = (int)b.z;  // right*4 + axis, -1 for a leaf
  w.meta = (int)b.w;       // start*16 + count
  return w;
}

// Push both children of an internal binary node, far first.
__device__ __forceinline__ void push_binary(const Ray& r, const Node8& w,
                                            int node, int* stack, int& top) {
  const int right = w.enc_right >> 2;
  const int axis = w.enc_right & 3;
  const int left = node + 1;
  const bool d_neg = sel3(axis, r.dx, r.dy, r.dz) < 0.0f;
  stack[top++] = d_neg ? left : right;  // far
  stack[top++] = d_neg ? right : left;  // near
}

__global__ void __launch_bounds__(128)
closest_hit_binary_kernel(const float* __restrict__ nodes8,
                          const float* __restrict__ tri9, Rays rays,
                          float* __restrict__ t_out, int* __restrict__ tri_out,
                          float* __restrict__ b1_out,
                          float* __restrict__ b2_out,
                          int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = make_ray(rays.ox[i], rays.oy[i], rays.oz[i], rays.dx[i],
                         rays.dy[i], rays.dz[i]);
  const bool active = rays.mask == nullptr || rays.mask[i] != 0;
  float t_best = rays.t_max[i];
  int tri_best = -1;
  float b1_best = 0.0f, b2_best = 0.0f;
  int pops = 0, leaf_pops = 0, tri_tests = 0;

  int stack[KSTACK];
  int top = 0;
  if (active) stack[top++] = 0;  // root node
  while (top > 0) {
    const int node = stack[--top];
    ++pops;
    const Node8 w = load_node8(nodes8, node);
    if (!hit_aabb(r, w.mn[0], w.mn[1], w.mn[2], w.mx[0], w.mx[1], w.mx[2],
                  t_best)) {
      continue;
    }
    if (w.enc_right < 0) {
      ++leaf_pops;
      const int start = w.meta >> 4;
      const int count = w.meta & 15;
      tri_tests += count;
      for (int k = 0; k < count; ++k) {
        const int ti = start + k;
        float t, b1, b2;
        if (hit_triangle(r, tri9 + 9 * (int64_t)ti, t_best, t, b1,
                               b2) &&
            t < t_best) {
          t_best = t;
          tri_best = ti;
          b1_best = b1;
          b2_best = b2;
        }
      }
    } else {
      push_binary(r, w, node, stack, top);
    }
  }
  t_out[i] = t_best;
  tri_out[i] = tri_best;
  b1_out[i] = b1_best;
  b2_out[i] = b2_best;
  write_stats(stats, rays.n, i, pops, leaf_pops, tri_tests);
}

__global__ void __launch_bounds__(128)
any_hit_binary_kernel(const float* __restrict__ nodes8,
                      const float* __restrict__ tri9, Rays rays,
                      uint8_t* __restrict__ occ_out,
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
    const int node = stack[--top];
    ++pops;
    const Node8 w = load_node8(nodes8, node);
    if (!hit_aabb(r, w.mn[0], w.mn[1], w.mn[2], w.mx[0], w.mx[1], w.mx[2],
                  t_max)) {
      continue;
    }
    if (w.enc_right < 0) {
      ++leaf_pops;
      const int start = w.meta >> 4;
      const int count = w.meta & 15;
      for (int k = 0; k < count; ++k) {
        float t, b1, b2;
        ++tri_tests;
        if (hit_triangle(r, tri9 + 9 * (int64_t)(start + k), t_max, t,
                               b1, b2)) {
          occ = true;  // occluded: stop at once
          break;
        }
      }
    } else {
      push_binary(r, w, node, stack, top);
    }
  }
  occ_out[i] = occ ? 1 : 0;
  write_stats(stats, rays.n, i, pops, leaf_pops, tri_tests);
}

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (attr) {
    closest_hit_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        nodes, tri9, attr16, rays, t_out, tri_out, b1_out, b2_out, nx_out,
        ny_out, nz_out, u_out, v_out, mt_out, stats);
  } else {
    closest_hit_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
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
  any_hit_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(nodes, tri9, rays,
                                                        occ_out, stats);
  return (int)cudaGetLastError();
}

// Binary pop-test closest hit over nodes8 rows; outputs and stats as
// pnrt_closest_hit without the fill.
int pnrt_closest_hit_binary(const float* nodes8, const float* tri9,
                            const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const float* t_max, const uint8_t* mask, int n,
                            float* t_out, int* tri_out, float* b1_out,
                            float* b2_out, int* stats, void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  closest_hit_binary_kernel<<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      nodes8, tri9, rays, t_out, tri_out, b1_out, b2_out, stats);
  return (int)cudaGetLastError();
}

int pnrt_any_hit_binary(const float* nodes8, const float* tri9,
                        const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const float* t_max, const uint8_t* mask, int n,
                        uint8_t* occ_out, int* stats, void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  any_hit_binary_kernel<<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      nodes8, tri9, rays, occ_out, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
