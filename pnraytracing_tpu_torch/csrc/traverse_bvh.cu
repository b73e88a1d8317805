// BVH walk for Hopper (sm_90a) over the scene's plain arrays: the walk of
// every scene outside the packed layout (route "bvh" of accel/route.py: a
// leaf of more than 15 triangles, more than 2^22 nodes or 2^20 triangles,
// a flat one-leaf BVH).
//
// Not a TPU kernel.  It is the port's kernel for the XLA walk of
// pnraytracing_tpu/accel/traverse.py (closest_hit, any_hit,
// traversal_stats: lax.while_loop over a [R, stack_depth] stack), which the
// JAX package takes for such scenes (render/integrator.py:443-452 there):
//   bvh_walk_kernel<true, C>   <- closest_hit / traversal_stats
//   bvh_walk_kernel<false, C>  <- any_hit
// C is the compat flag of that walk's `compat` argument (intersect.cuh).
//
// What it computes, step for step the XLA walk's, so that the per-ray
// stats match it: one thread walks one ray with its own stack (the XLA
// walk pops one node per ray per lockstep iteration; a thread's pops are
// the iterations in which its ray was active).  A popped node tests its
// box against the current best t (closest) or t_max (any).  A leaf tests
// triangles start .. min(end, start + max_leaf) against the leaf-entry
// bound, and a triangle wins only if its t is below the running best, so
// the first of equal t keeps the hit; the any-hit walk stops at its first
// hit.  An internal node takes near / far by the sign of d[axis]
// (_children, traverse.py:61-70), tests both boxes against the best t
// after the leaf step, and pushes far, then near.  Masked rays pop
// nothing.  A NaN ray (never_enters of intersect.cuh) pops the root and
// fails its box, as in the XLA walk, whose reductions keep the NaN where
// fminf / fmaxf would drop it.
//
// Inputs, read as they are: bvh.node_min / node_max [N, 3] f32, axis,
// right_child, start, end [N] i32, mesh.indices [T, 3] i32 (in leaf
// order) and mesh.positions [V, 3] f32.  A triangle is three index loads,
// then three vertices.  Arithmetic: the array forms intersect_aabb /
// intersect_triangle of ops/intersect.py, which are op for op the slab and
// watertight tests of intersect.cuh (hit_aabb, hit_corners); built with
// --fmad=false, so kernel and plain version (accel/traverse.py) agree bit
// for bit.
//
// Stack.  KSTACK entries in local memory.  A push writes at min(top,
// stack_depth - 1) and a pop reads at min(top - 1, stack_depth - 1), the
// XLA walk's clipped indices; the integrator's guard stack_depth >=
// bvh_depth keeps the stack from ever filling, and the clip only keeps a
// direct call over a deeper tree inside the thread's own array.
//
// What bounds it.  The chains of dependent reads, as the resident walks
// (traverse.cu): each pop waits for its node's box, then its topology,
// then both children's boxes, and each triangle for its indices, then its
// vertices.  Neither bytes (rays in and out, each table once) nor the
// slab and triangle operations come near the time.  The design is the
// simple one: one loop, no while-while, no row in flight.
//
// Stats ([3, n] int32 when requested): pops, slab tests (one a pop, two
// more a pop of an internal node whose box was hit) and triangle tests.

#include "intersect.cuh"

namespace pnrt {
namespace {

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

struct Tree {
  const float* node_min;   // [N, 3]
  const float* node_max;   // [N, 3]
  const int* axis;         // [N]
  const int* right;        // [N], -1 at a leaf
  const int* start;        // [N]
  const int* end;          // [N]
  const int* indices;      // [T, 3]
  const float* positions;  // [V, 3]
  int max_leaf;
};

struct Out {
  float* t;
  int* tri;
  float* b1;
  float* b2;
  uint8_t* occ;
  int* stats;
};

__device__ __forceinline__ int ldi(const int* p) { return __ldg(p); }

template <bool COMPAT>
__device__ __forceinline__ bool node_box(const Ray& r, const Tree& tr,
                                         int node, float t) {
  const float* mn = tr.node_min + 3 * node;
  const float* mx = tr.node_max + 3 * node;
  return hit_aabb<COMPAT>(r, ldf(mn), ldf(mn + 1), ldf(mn + 2), ldf(mx),
                          ldf(mx + 1), ldf(mx + 2), t);
}

__device__ __forceinline__ bool triangle(const Ray& r, const Tree& tr,
                                         int ti, float t_lim, float& t,
                                         float& b1, float& b2) {
  const int* ix = tr.indices + 3 * ti;
  const float* p0 = tr.positions + 3 * ldi(ix);
  const float* p1 = tr.positions + 3 * ldi(ix + 1);
  const float* p2 = tr.positions + 3 * ldi(ix + 2);
  return hit_corners(r, ldf(p0), ldf(p0 + 1), ldf(p0 + 2), ldf(p1),
                     ldf(p1 + 1), ldf(p1 + 2), ldf(p2), ldf(p2 + 1),
                     ldf(p2 + 2), t_lim, t, b1, b2);
}

template <bool CLOSEST, bool COMPAT>
__global__ void __launch_bounds__(kThreads)
    bvh_walk_kernel(Tree tr, Rays rays, int stack_depth, Out out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = make_ray<COMPAT>(rays.ox[i], rays.oy[i], rays.oz[i],
                                 rays.dx[i], rays.dy[i], rays.dz[i]);
  const float t_max = rays.t_max[i];
  const bool enters = !never_enters(r);
  const int cap = min(stack_depth, KSTACK) - 1;
  float t_best = t_max, b1 = 0.0f, b2 = 0.0f;
  int tri = -1;
  bool occ = false;
  int pops = 0, slabs = 0, tests = 0;
  int stack[KSTACK];
  int top = 0;
  if (rays.mask == nullptr || rays.mask[i] != 0) stack[top++] = 0;

  while (top > 0) {
    const int node = stack[min(top - 1, cap)];
    --top;
    ++pops;
    ++slabs;
    const float t_lim = CLOSEST ? t_best : t_max;
    if (!(enters && node_box<COMPAT>(r, tr, node, t_lim))) continue;
    const int right = ldi(tr.right + node);
    if (right < 0) {
      const int s = ldi(tr.start + node);
      const int e = min(ldi(tr.end + node), s + tr.max_leaf);
      for (int ti = s; ti < e; ++ti) {
        float t, u, v;
        ++tests;
        const bool h = triangle(r, tr, ti, t_lim, t, u, v);
        if constexpr (CLOSEST) {
          if (h && t < t_best) {
            t_best = t;
            tri = ti;
            b1 = u;
            b2 = v;
          }
        } else if (h) {
          occ = true;
          break;
        }
      }
      if (occ) break;  // the any-hit walk's early exit
    } else {
      const int ax = ldi(tr.axis + node);
      const bool neg = sel3(max(ax, 0), r.dx, r.dy, r.dz) < 0.0f;
      const int near_c = neg ? right : node + 1;
      const int far_c = neg ? node + 1 : right;
      slabs += 2;
      const bool far_ok = node_box<COMPAT>(r, tr, far_c, t_lim);
      const bool near_ok = node_box<COMPAT>(r, tr, near_c, t_lim);
      if (far_ok) stack[min(top++, cap)] = far_c;
      if (near_ok) stack[min(top++, cap)] = near_c;
    }
  }

  if constexpr (CLOSEST) {
    out.t[i] = t_best;
    out.tri[i] = tri;
    out.b1[i] = b1;
    out.b2[i] = b2;
  } else {
    out.occ[i] = occ ? 1 : 0;
  }
  if (out.stats != nullptr) {
    out.stats[i] = pops;
    out.stats[rays.n + i] = slabs;
    out.stats[2 * rays.n + i] = tests;
  }
}

template <bool COMPAT>
const void* bvh_kernel(int closest) {
  return closest ? (const void*)bvh_walk_kernel<true, COMPAT>
                 : (const void*)bvh_walk_kernel<false, COMPAT>;
}

}  // namespace
}  // namespace pnrt

using namespace pnrt;

extern "C" {

// The walk over the plain BVH arrays: closest != 0 writes t / tri / b1 /
// b2 (t_max and -1 on a miss), else occ; compat != 0 launches the compat
// instantiation; stats may be null, else [3, n] int32 (pops, slab tests,
// triangle tests).  Returns cudaGetLastError() after the launch.
int pnrt_bvh_walk(const float* node_min, const float* node_max,
                  const int* axis, const int* right, const int* start,
                  const int* end, const int* indices, const float* positions,
                  int max_leaf, int stack_depth, const float* ox,
                  const float* oy, const float* oz, const float* dx,
                  const float* dy, const float* dz, const float* t_max,
                  const uint8_t* mask, int n, int closest, int compat,
                  float* t_out, int* tri_out, float* b1_out, float* b2_out,
                  uint8_t* occ_out, int* stats, void* stream) {
  if (n <= 0) return 0;
  const Tree tr = {node_min, node_max, axis,    right,    start,
                   end,      indices,  positions, max_leaf};
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  const Out out = {t_out, tri_out, b1_out, b2_out, occ_out, stats};
  auto kernel = closest ? (compat ? bvh_walk_kernel<true, true>
                                  : bvh_walk_kernel<true, false>)
                        : (compat ? bvh_walk_kernel<false, true>
                                  : bvh_walk_kernel<false, false>);
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tr, rays, stack_depth, out);
  return (int)cudaGetLastError();
}

// What the card gives the walk (closest != 0: the closest-hit form, in its
// compat instantiation when compat != 0): what == 0 the registers a
// thread, 1 the blocks an SM holds at once, 2 the threads a block, 3 the
// bytes of local memory a thread.  A negative value is minus the CUDA
// error.
int pnrt_bvh_kernel_info(int closest, int compat, int what) {
  const void* kernel =
      compat ? bvh_kernel<true>(closest) : bvh_kernel<false>(closest);
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

}  // extern "C"
