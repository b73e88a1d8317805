// BVH traversal kernels for Hopper (sm_90a) over a scene resident in
// device memory: closest hit, closest hit with the interaction fill and
// any hit over the compact wide rows, and the binary pop-test walks.
//
// Replaces the TPU kernels of pnraytracing_tpu/accel/traverse_pallas.py:
//   closest_hit_kernel<true, C>   <- _closest_kernel_wide_attr
//   closest_hit_kernel<false, C>  <- _closest_kernel_wide (the same
//                                    template with the fill compiled out)
//   any_hit_kernel<C>             <- _any_kernel_wide
//   closest_hit_binary_kernel<C>  <- _closest_kernel
//   any_hit_binary_kernel<C>      <- _any_kernel
// C is the compile-time compat flag of each Pallas kernel's `compat`
// argument (intersect.cuh): C = true reproduces the reference's ray setup
// and interval-free slab test, so its walks visit every box the ray's
// line crosses.  Each launcher takes `compat` and picks the instantiation.
//
// What they compute.  The wide walk is push-test over nodes16c [N, 16]
// rows: visiting an internal row slab-tests BOTH children against the
// ray's current t, goes on into the near hit child (by this ray's own
// direction sign on the row's split axis) and keeps the far hit child for
// later; visiting a leaf runs its triangle tests.  The binary walk is
// pop-test over nodes8 [N, 8] rows (min, max, enc(right*4+axis),
// enc(start*16+count)): a popped node tests its own box, then tests its
// leaf's triangles or pushes both children (left = node + 1), far first.
// The Pallas kernels walk one SHARED stack per 128-lane ray tile, because
// Mosaic cannot index a different node per lane; Hopper can, so every
// thread walks its own ray.  The tables stay in device memory and are read
// through __ldg: ~0.7 MB for the flagship teapot, ~8.5 MB for the 102k-
// triangle scene, all within the 50 MB L2.  Arithmetic and --fmad=false:
// see intersect.cuh.
//
// What bounds the wide walks.  Not bytes and not operations: the byte
// bound (rays in and out, each table once at 3.35 TB/s) and the operation
// bound (the counted slab and triangle tests at 67 TFLOP/s fp32) are both
// ~0.005 ms at the flagship's 262,144 bounce-0 rays, and even the bytes
// the walks touch would take 0.05 ms from HBM but come from L1/L2.  The
// time is set by the LONGEST CHAINS OF DEPENDENT READS: each visit waits
// for a row or a triangle from the L2 before it knows the next address
// (~450 cycles a step), and a ray's visits cannot overlap.  Measured on an
// NVIDIA H100 80GB HBM3, 700.00 W (scripts of PERF.md section 6): the
// closest walk without the 1% of rays with the longest chains (> 45
// visits + tests; the longest is 196) takes 0.039 ms instead of 0.081,
// the same launch with every ray twice only 0.102.  Lane idleness is not
// the limiter: 70% of a closest warp's lane slots do work (40% of an
// any-hit warp's, whose batch is half masked).
//
// What the design does about it: it shortens the chain of the slowest
// rays and keeps other lanes' work out of it.
//   * While-while: an inner loop descends rows until this lane holds a
//     leaf, then the warp's lanes test their leaves together, so a long
//     ray's descent no longer waits for its neighbours' triangle tests at
//     every step (the one-loop form ran both branches in ~half of a
//     warp's iterations).  The order of visits, the results and the
//     per-ray stats are unchanged.
//   * In a closest-hit leaf the next triangle's row is already in flight
//     while one is tested (a leaf's rows are contiguous), which takes one
//     L2 latency out of every test but a leaf's first.  Not in the any-hit
//     leaf, which stops at its first hit and gained nothing from it.
//   * The current node lives in a register: the walk goes into the near
//     child directly and only the far child goes through the stack in
//     local memory (before: two dependent stores and a load per row).
//   * Triangles are read from tri12 [T, 12], the corners padded to three
//     aligned float4, instead of nine scalar words of a 36-byte row.
//   * The interaction fill (four float4 of tri_attr16 and the
//     interpolation) depends only on the winning (tri, b1, b2), so it runs
//     once after the walk; inside the walk it cost 8 registers and a
//     block an SM.
// Measured and not kept (same card, PERF.md section 6): blocks of 64 and
// 256 threads, a register cap for 12 or 16 blocks an SM (spills; 23-42%
// slower), a 32-entry stack, the stack in shared memory, warps that fetch
// their next 32 rays from a counter, prefetch instructions for both
// children's rows, two or three triangles in flight, and the walk that
// postpones a leaf and goes on descending (more visits, slower any-hit).
// The binary walk visits about twice as many nodes as the wide one for
// the same hits.  Both binary kernels have the while-while form with a
// bounded descent (see closest_hit_binary_kernel and
// any_hit_binary_kernel).
//
// Rays of never_enters (a NaN component, or an infinite origin and
// direction on one axis) walk nothing in every kernel, as in the plain
// versions (intersect.cuh).
//
// The leaf cap.  Every kernel takes max_leaf and tests at most that many
// triangles of a leaf (min(count, max_leaf)), as the Pallas kernels'
// leaf loops do (`for k in range(max_leaf_size)`, traverse_pallas.py:185
// and after) and the JAX package's XLA walks (traverse_packed.py:40-49,
// traverse_packet.py:66, traverse_wide.py:38 there).  The integrator
// passes RenderConfig.max_leaf_size on every route: the routes of
// traversal="pallas" and those of the XLA values that reuse these kernels
// (5 / 6 for "pop" and "packet", 3 / 2 for "wide").  A scene built with
// the default leaf size (4) has no leaf over the default cap, so the cap
// changes nothing there.

#include "intersect.cuh"

using namespace pnrt;

namespace {

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// Where a closest-hit walk writes: the hit, the interaction fill (null
// without it) and the stats (may be null).
struct ClosestOut {
  float* t;
  int* tri;
  float *b1, *b2, *nx, *ny, *nz, *u, *v;
  int *mt, *stats;
};

struct Best {
  float t;
  int tri;
  float b1, b2;
};

// The triangle tests of leaf `info` (its first max_leaf triangles) against
// the closest hit so far.  The next triangle's row is loaded before this
// one is tested (past the leaf's end the last row is read again).
__device__ __forceinline__ void closest_leaf(const Ray& r,
                                             const float* __restrict__ tris,
                                             int info, int max_leaf, Best& h,
                                             int& tri_tests) {
  const int meta = -info - 1;
  const int start = meta >> 4;
  const int count = min(meta & 15, max_leaf);
  if (count == 0) return;
  tri_tests += count;
  const float* p = tris + 12 * (int64_t)start;
  Tri next = load_tri12(p);
  for (int k = 0; k < count; ++k) {
    const Tri v = next;
    next = load_tri12(p + 12 * min(k + 1, count - 1));
    float t, b1, b2;
    if (hit_tri(r, v, h.t, t, b1, b2) && t < h.t) {
      h.t = t;
      h.tri = start + k;
      h.b1 = b1;
      h.b2 = b2;
    }
  }
}

// True when one of the first max_leaf triangles of leaf `info` is hit
// within t_max; stops at the first.
__device__ __forceinline__ bool any_leaf(const Ray& r,
                                         const float* __restrict__ tris,
                                         int info, int max_leaf, float t_max,
                                         int& tri_tests) {
  const int meta = -info - 1;
  const int start = meta >> 4;
  const int count = min(meta & 15, max_leaf);
  for (int k = 0; k < count; ++k) {
    float t, b1, b2;
    ++tri_tests;
    if (hit_tri(r, load_tri12(tris + 12 * (int64_t)(start + k)), t_max, t,
                b1, b2)) {
      return true;
    }
  }
  return false;
}

// The wide kernels state one block an SM as their least, which leaves
// the compiler every register it wants (occupancy is not what limits
// them; capped at 40 registers they ran 10-23% slower).
template <bool ATTR, bool COMPAT>
__global__ void __launch_bounds__(kThreads, 1)
closest_hit_kernel(const float* __restrict__ nodes,
                   const float* __restrict__ tris,
                   const float* __restrict__ attr16, Rays rays,
                   int max_leaf, ClosestOut out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = make_ray<COMPAT>(rays.ox[i], rays.oy[i], rays.oz[i],
                                 rays.dx[i], rays.dy[i], rays.dz[i]);
  const bool active = walks(rays, i, r);
  Best h = {rays.t_max[i], -1, 0.0f, 0.0f};
  int pops = 0, leaf_pops = 0, tri_tests = 0;

  int stack[KSTACK];  // the far children still to visit
  int top = 0;
  int cur = active ? 0 : kWalkDone;  // the root row
  while (cur != kWalkDone) {
    while (cur >= 0) {  // descend rows until this lane holds a leaf
      ++pops;
      cur = next_node<COMPAT>(r, load_row(nodes + 16 * (int64_t)cur), h.t,
                              stack, top);
    }
    if (cur != kWalkDone) {
      ++pops;
      ++leaf_pops;
      closest_leaf(r, tris, cur, max_leaf, h, tri_tests);
      cur = pop_node(stack, top);
    }
  }
  out.t[i] = h.t;
  out.tri[i] = h.tri;
  out.b1[i] = h.b1;
  out.b2[i] = h.b2;
  if (ATTR) {
    // the interaction fill of the winning hit; on a miss normal +z, uv 0,
    // word 0
    float nx = 0.0f, ny = 0.0f, nz = 1.0f, u = 0.0f, v = 0.0f;
    int mt = 0;
    if (h.tri >= 0) {
      const float b0 = 1.0f - h.b1 - h.b2;
      const float* q = attr16 + 16 * (int64_t)h.tri;
      const float4 a = ldf4(q), b = ldf4(q + 4), c = ldf4(q + 8),
                   d = ldf4(q + 12);
      nx = a.x * b0 + a.w * h.b1 + b.z * h.b2;
      ny = a.y * b0 + b.x * h.b1 + b.w * h.b2;
      nz = a.z * b0 + b.y * h.b1 + c.x * h.b2;
      u = c.y * b0 + c.w * h.b1 + d.y * h.b2;
      v = c.z * b0 + d.x * h.b1 + d.z * h.b2;
      mt = (int)d.w;
    }
    out.nx[i] = nx;
    out.ny[i] = ny;
    out.nz[i] = nz;
    out.u[i] = u;
    out.v[i] = v;
    out.mt[i] = mt;
  }
  write_stats(out.stats, rays.n, i, pops, leaf_pops, tri_tests);
}

template <bool COMPAT>
__global__ void __launch_bounds__(kThreads, 1)
any_hit_kernel(const float* __restrict__ nodes,
               const float* __restrict__ tris, Rays rays, int max_leaf,
               uint8_t* __restrict__ occ_out, int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = make_ray<COMPAT>(rays.ox[i], rays.oy[i], rays.oz[i],
                                 rays.dx[i], rays.dy[i], rays.dz[i]);
  const bool active = walks(rays, i, r);
  const float t_max = rays.t_max[i];
  bool occ = false;
  int pops = 0, leaf_pops = 0, tri_tests = 0;

  int stack[KSTACK];
  int top = 0;
  int cur = active ? 0 : kWalkDone;
  while (cur != kWalkDone) {
    while (cur >= 0) {
      ++pops;
      cur = next_node<COMPAT>(r, load_row(nodes + 16 * (int64_t)cur), t_max,
                              stack, top);
    }
    if (cur != kWalkDone) {
      ++pops;
      ++leaf_pops;
      occ = any_leaf(r, tris, cur, max_leaf, t_max, tri_tests);
      cur = occ ? kWalkDone : pop_node(stack, top);  // occluded: stop
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

// One pop of a binary walk at node cur, against t: a node whose box the
// ray misses gives the stack's top; a leaf whose box it hits sets meta
// (start*16 + count) and stays; an inner node goes on into its near child
// (left = node + 1) and pushes the far one.
template <bool COMPAT>
__device__ __forceinline__ int binary_pop(const Ray& r,
                                          const float* __restrict__ nodes8,
                                          int cur, float t, int* stack,
                                          int& top, int& meta) {
  const Node8 w = load_node8(nodes8, cur);
  if (!hit_aabb<COMPAT>(r, w.mn[0], w.mn[1], w.mn[2], w.mx[0], w.mx[1],
                        w.mx[2], t)) {
    return pop_node(stack, top);
  }
  if (w.enc_right < 0) {
    meta = w.meta;
    return cur;
  }
  const int right = w.enc_right >> 2;
  const bool d_neg = sel3(w.enc_right & 3, r.dx, r.dy, r.dz) < 0.0f;
  stack[top++] = d_neg ? cur + 1 : right;  // far
  return d_neg ? right : cur + 1;          // near
}

// The binary closest walk, while-while with a bounded descent: an inner
// loop pops and box-tests nodes until this lane holds a leaf whose box it
// hit, but for at most kBinaryDescent pops; then the warp's lanes that
// hold a leaf test it together.  The bound is what makes the form pay
// here.  A lane that holds a leaf waits for the others' descents, and a
// binary walk pops twice as many nodes between two leaves as the wide one:
// unbounded, the wait lengthens the longest rays' chains (2% faster on the
// flagship's rays, 16% slower on the large scene's than one loop); bounded
// at 4, a leaf-holder waits three pops at most and the walk is 1.10x /
// 1.11x faster than one loop (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// section 6; 2, 3, 5, 6, 8 and 16 pops and warp votes measured beside it).
// The near child is entered directly and only the far one pushed (a child
// entered directly counts as a pop); the leaf's triangles come from tri12
// with the next row in flight (closest_leaf).  The order of visits, the
// hit and the stats are those of the one-loop pop-test walk.
constexpr int kBinaryDescent = 4;

template <bool COMPAT>
__global__ void __launch_bounds__(kThreads, 1)
closest_hit_binary_kernel(const float* __restrict__ nodes8,
                          const float* __restrict__ tri12, Rays rays,
                          int max_leaf, float* __restrict__ t_out,
                          int* __restrict__ tri_out,
                          float* __restrict__ b1_out,
                          float* __restrict__ b2_out,
                          int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = make_ray<COMPAT>(rays.ox[i], rays.oy[i], rays.oz[i],
                                 rays.dx[i], rays.dy[i], rays.dz[i]);
  const bool active = walks(rays, i, r);
  Best h = {rays.t_max[i], -1, 0.0f, 0.0f};
  int pops = 0, leaf_pops = 0, tri_tests = 0;

  int stack[KSTACK];  // the far children still to visit
  int top = 0;
  int cur = active ? 0 : kWalkDone;  // the root node
  while (cur != kWalkDone) {
    int meta = -1;  // start*16 + count of the leaf this lane holds
#pragma unroll 1
    for (int step = 0; step < kBinaryDescent && cur != kWalkDone && meta < 0;
         ++step) {
      ++pops;
      cur = binary_pop<COMPAT>(r, nodes8, cur, h.t, stack, top, meta);
    }
    if (meta >= 0) {
      ++leaf_pops;
      closest_leaf(r, tri12, -meta - 1, max_leaf, h, tri_tests);
      cur = pop_node(stack, top);
    }
  }
  t_out[i] = h.t;
  tri_out[i] = h.tri;
  b1_out[i] = h.b1;
  b2_out[i] = h.b2;
  write_stats(stats, rays.n, i, pops, leaf_pops, tri_tests);
}

// The binary any-hit walk in the same form: the descent bounded at
// kAnyDescent pops against the fixed t_max, the near child entered
// directly, and the warp's leaf-holders test their leaves together
// (any_leaf over tri12: three aligned float4 a triangle, no row in flight,
// which did not pay in the wide any-hit leaf).  A hit ends the walk.  The
// order of visits, the occlusion and the stats are those of the one-loop
// walk that pushed both children, far first.  Its rays reach a leaf far
// more rarely than the closest walk's (0.24 / 0.52 leaf pops a ray on the
// flagship's / the large scene's shadow batch against 14.6 / 13.4 pops),
// so it takes a longer bound: 8 pops ran 1.04x / 1.01x faster than the
// one-loop form on those batches, 4 pops 1.02x / 1.01x, 2 pops slower on
// both; tri9 leaves within 0.8% of tri12, plain launch bounds 2.3% slower
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
constexpr int kAnyDescent = 8;

template <bool COMPAT>
__global__ void __launch_bounds__(kThreads, 1)
any_hit_binary_kernel(const float* __restrict__ nodes8,
                      const float* __restrict__ tri12, Rays rays,
                      int max_leaf, uint8_t* __restrict__ occ_out,
                      int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = make_ray<COMPAT>(rays.ox[i], rays.oy[i], rays.oz[i],
                                 rays.dx[i], rays.dy[i], rays.dz[i]);
  const bool active = walks(rays, i, r);
  const float t_max = rays.t_max[i];
  bool occ = false;
  int pops = 0, leaf_pops = 0, tri_tests = 0;

  int stack[KSTACK];  // the far children still to visit
  int top = 0;
  int cur = active ? 0 : kWalkDone;  // the root node
  while (cur != kWalkDone) {
    int meta = -1;  // start*16 + count of the leaf this lane holds
#pragma unroll 1
    for (int step = 0; step < kAnyDescent && cur != kWalkDone && meta < 0;
         ++step) {
      ++pops;
      cur = binary_pop<COMPAT>(r, nodes8, cur, t_max, stack, top, meta);
    }
    if (meta >= 0) {
      ++leaf_pops;
      occ = any_leaf(r, tri12, -meta - 1, max_leaf, t_max, tri_tests);
      cur = occ ? kWalkDone : pop_node(stack, top);  // occluded: stop
    }
  }
  occ_out[i] = occ ? 1 : 0;
  write_stats(stats, rays.n, i, pops, leaf_pops, tri_tests);
}

// The instantiation of one resident walk kernel (which: 0 closest +
// fill, 1 closest, 2 any, 3 binary closest, 4 binary any).
template <bool COMPAT>
const void* walk_kernel(int which) {
  return which == 0   ? (const void*)closest_hit_kernel<true, COMPAT>
         : which == 1 ? (const void*)closest_hit_kernel<false, COMPAT>
         : which == 2 ? (const void*)any_hit_kernel<COMPAT>
         : which == 3 ? (const void*)closest_hit_binary_kernel<COMPAT>
                      : (const void*)any_hit_binary_kernel<COMPAT>;
}

}  // namespace

extern "C" {

// Closest hit over the wide rows and the padded triangle rows tri12; with
// attr != 0 also the interaction fill (nx..mt must then be non-null);
// compat != 0 launches the compat instantiation; at most max_leaf
// triangles of a leaf are tested.  stats may be null, else [3, n] int32:
// pops, leaf pops, triangle tests.  Returns cudaGetLastError() after the
// launch.
int pnrt_closest_hit(const float* nodes, const float* tri12,
                     const float* attr16, const float* ox, const float* oy,
                     const float* oz, const float* dx, const float* dy,
                     const float* dz, const float* t_max,
                     const uint8_t* mask, int n, int attr, int compat,
                     int max_leaf, float* t_out, int* tri_out, float* b1_out,
                     float* b2_out, float* nx_out, float* ny_out,
                     float* nz_out, float* u_out, float* v_out, int* mt_out,
                     int* stats, void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  const ClosestOut out = {t_out,  tri_out, b1_out, b2_out, nx_out, ny_out,
                          nz_out, u_out,   v_out,  mt_out, stats};
  auto kernel = attr ? (compat ? closest_hit_kernel<true, true>
                                : closest_hit_kernel<true, false>)
                     : (compat ? closest_hit_kernel<false, true>
                               : closest_hit_kernel<false, false>);
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, tri12, attr ? attr16 : nullptr, rays, max_leaf, out);
  return (int)cudaGetLastError();
}

int pnrt_any_hit(const float* nodes, const float* tri12, const float* ox,
                 const float* oy, const float* oz, const float* dx,
                 const float* dy, const float* dz, const float* t_max,
                 const uint8_t* mask, int n, int compat, int max_leaf,
                 uint8_t* occ_out, int* stats, void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  auto kernel = compat ? any_hit_kernel<true> : any_hit_kernel<false>;
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, tri12, rays, max_leaf, occ_out, stats);
  return (int)cudaGetLastError();
}

// What the card gives a resident walk kernel (which as walk_kernel, in
// its compat instantiation when compat != 0): what == 0 the registers a
// thread, 1 the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), 2 the threads a block,
// 3 the bytes of local memory a thread.  A negative value is minus the
// CUDA error.
int pnrt_walk_kernel_info(int which, int compat, int what) {
  const void* kernel =
      compat ? walk_kernel<true>(which) : walk_kernel<false>(which);
  if (what == 2) return kThreads;
  if (what == 1) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, 0);
    return err == cudaSuccess ? blocks : -(int)err;
  }
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return -(int)err;
  return what == 0 ? a.numRegs : (int)a.localSizeBytes;
}

// Binary pop-test closest hit over nodes8 rows and tri12; max_leaf,
// outputs and stats as pnrt_closest_hit without the fill.
int pnrt_closest_hit_binary(const float* nodes8, const float* tri12,
                            const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const float* t_max, const uint8_t* mask, int n,
                            int compat, int max_leaf, float* t_out,
                            int* tri_out, float* b1_out, float* b2_out,
                            int* stats, void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  auto kernel = compat ? closest_hit_binary_kernel<true>
                       : closest_hit_binary_kernel<false>;
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes8, tri12, rays, max_leaf, t_out, tri_out, b1_out, b2_out, stats);
  return (int)cudaGetLastError();
}

int pnrt_any_hit_binary(const float* nodes8, const float* tri12,
                        const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const float* t_max, const uint8_t* mask, int n,
                        int compat, int max_leaf, uint8_t* occ_out,
                        int* stats, void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  auto kernel = compat ? any_hit_binary_kernel<true>
                       : any_hit_binary_kernel<false>;
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes8, tri12, rays, max_leaf, occ_out, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
