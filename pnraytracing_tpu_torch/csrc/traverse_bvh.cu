// BVH walk for Hopper (sm_90a), push-test, one thread a ray, over either
// of two layouts of the same tree:
//   * the scene's plain arrays (PlainTree): the walk of every scene
//     outside the packed layout (route "bvh" of accel/route.py: a leaf of
//     more than 15 triangles, more than 2^22 nodes or 2^20 triangles, a
//     flat one-leaf BVH);
//   * the packed rows nodes8 + tri12 (PackedRows): the walk of
//     RenderConfig.traversal="packed" (accel/traverse_packed.py).
//
// Not a TPU kernel.  It is the port's kernel for two XLA walks of the JAX
// package, which visit the same nodes in the same order and differ only
// in the rows they read:
//   bvh_walk_kernel<true, C, PlainTree>    <- accel/traverse.py
//       closest_hit / traversal_stats (lax.while_loop over a
//       [R, stack_depth] stack; render/integrator.py:443-452 there)
//   bvh_walk_kernel<false, C, PlainTree>   <- accel/traverse.py any_hit
//   bvh_walk_kernel<true, C, PackedRows>   <- accel/traverse_packed.py
//       _closest_hit_flat (closest_hit_packed)
//   bvh_walk_kernel<false, C, PackedRows>  <- _any_hit_flat (any_hit_packed)
// C is the compat flag of those walks' `compat` argument (intersect.cuh).
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
// Inputs, read as they are.  PlainTree: bvh.node_min / node_max [N, 3]
// f32, axis, right_child, start, end [N] i32, mesh.indices [T, 3] i32 (in
// leaf order) and mesh.positions [V, 3] f32; a triangle is three index
// loads, then three vertices.  PackedRows: nodes8 [N, 8] (min, max,
// enc(right*4 + axis), enc(start*16 + count), exact small-int floats;
// accel/layout.py::pack_nodes8) and tri12 [T, 12]; a node's box and
// topology are one 32-byte row, a triangle three float4.  The packed
// count is min(count, 15), which every packed scene's leaves are within.
// Arithmetic: the array forms intersect_aabb / intersect_triangle of
// ops/intersect.py, which are op for op the slab and watertight tests of
// intersect.cuh (hit_aabb, hit_corners); built with --fmad=false, so
// kernel and plain versions (accel/traverse.py, accel/traverse_packed.py)
// agree bit for bit.
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
// vertices (PlainTree) or its row (PackedRows).  Neither bytes (rays in
// and out, each table once) nor the slab and triangle operations come near
// the time.  The design is the simple one: one loop, no while-while, no
// row in flight; the packed layout reads a node's row once for its box and
// again (from L1) for its topology.
//
// Stats ([3, n] int32 when requested): pops, slab tests (one a pop, two
// more a pop of an internal node whose box was hit) and triangle tests.

#include "intersect.cuh"

namespace pnrt {
namespace {

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

__device__ __forceinline__ int ldi(const int* p) { return __ldg(p); }

// The scene's plain arrays.
struct PlainTree {
  const float* node_min;   // [N, 3]
  const float* node_max;   // [N, 3]
  const int* axis;         // [N]
  const int* right_child;  // [N], -1 at a leaf
  const int* start;        // [N]
  const int* end;          // [N]
  const int* indices;      // [T, 3]
  const float* positions;  // [V, 3]

  template <bool COMPAT>
  __device__ __forceinline__ bool box(const Ray& r, int node,
                                      float t) const {
    const float* mn = node_min + 3 * node;
    const float* mx = node_max + 3 * node;
    return hit_aabb<COMPAT>(r, ldf(mn), ldf(mn + 1), ldf(mn + 2), ldf(mx),
                            ldf(mx + 1), ldf(mx + 2), t);
  }
  __device__ __forceinline__ int right(int node) const {
    return ldi(right_child + node);
  }
  __device__ __forceinline__ int split_axis(int node) const {
    return max(ldi(axis + node), 0);
  }
  __device__ __forceinline__ void leaf(int node, int& s, int& e) const {
    s = ldi(start + node);
    e = ldi(end + node);
  }
  __device__ __forceinline__ bool triangle(const Ray& r, int ti, float t_lim,
                                           float& t, float& b1,
                                           float& b2) const {
    const int* ix = indices + 3 * ti;
    const float* p0 = positions + 3 * ldi(ix);
    const float* p1 = positions + 3 * ldi(ix + 1);
    const float* p2 = positions + 3 * ldi(ix + 2);
    return hit_corners(r, ldf(p0), ldf(p0 + 1), ldf(p0 + 2), ldf(p1),
                       ldf(p1 + 1), ldf(p1 + 2), ldf(p2), ldf(p2 + 1),
                       ldf(p2 + 2), t_lim, t, b1, b2);
  }
};

// The packed rows: nodes8 [N, 8] and tri12 [T, 12], both 16-byte aligned.
struct PackedRows {
  const float* nodes8;
  const float* tri12;

  __device__ __forceinline__ int enc_right(int node) const {
    return (int)ldf(nodes8 + 8 * (int64_t)node + 6);  // right*4 + axis, -1
  }
  template <bool COMPAT>
  __device__ __forceinline__ bool box(const Ray& r, int node,
                                      float t) const {
    const float* p = nodes8 + 8 * (int64_t)node;
    const float4 a = ldf4(p), b = ldf4(p + 4);
    return hit_aabb<COMPAT>(r, a.x, a.y, a.z, a.w, b.x, b.y, t);
  }
  __device__ __forceinline__ int right(int node) const {
    const int enc = enc_right(node);
    return enc < 0 ? -1 : enc >> 2;
  }
  __device__ __forceinline__ int split_axis(int node) const {
    const int enc = enc_right(node);
    return enc < 0 ? 0 : enc & 3;
  }
  __device__ __forceinline__ void leaf(int node, int& s, int& e) const {
    const int meta = (int)ldf(nodes8 + 8 * (int64_t)node + 7);
    s = meta >> 4;
    e = s + (meta & 15);
  }
  __device__ __forceinline__ bool triangle(const Ray& r, int ti, float t_lim,
                                           float& t, float& b1,
                                           float& b2) const {
    return hit_tri(r, load_tri12(tri12 + 12 * (int64_t)ti), t_lim, t, b1,
                   b2);
  }
};

struct Out {
  float* t;
  int* tri;
  float* b1;
  float* b2;
  uint8_t* occ;
  int* stats;
};

template <bool CLOSEST, bool COMPAT, typename Layout>
__global__ void __launch_bounds__(kThreads)
    bvh_walk_kernel(Layout tr, Rays rays, int max_leaf, int stack_depth,
                    Out out) {
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
    if (!(enters && tr.template box<COMPAT>(r, node, t_lim))) continue;
    const int right = tr.right(node);
    if (right < 0) {
      int s, e;
      tr.leaf(node, s, e);
      e = min(e, s + max_leaf);
      for (int ti = s; ti < e; ++ti) {
        float t, u, v;
        ++tests;
        const bool h = tr.triangle(r, ti, t_lim, t, u, v);
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
      const bool neg = sel3(tr.split_axis(node), r.dx, r.dy, r.dz) < 0.0f;
      const int near_c = neg ? right : node + 1;
      const int far_c = neg ? node + 1 : right;
      slabs += 2;
      const bool far_ok = tr.template box<COMPAT>(r, far_c, t_lim);
      const bool near_ok = tr.template box<COMPAT>(r, near_c, t_lim);
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

template <bool COMPAT, typename Layout>
const void* bvh_kernel(int closest) {
  return closest ? (const void*)bvh_walk_kernel<true, COMPAT, Layout>
                 : (const void*)bvh_walk_kernel<false, COMPAT, Layout>;
}

template <typename Layout>
int launch(const Layout& tr, const Rays& rays, int max_leaf,
           int stack_depth, int closest, int compat, const Out& out,
           void* stream) {
  auto kernel =
      closest ? (compat ? bvh_walk_kernel<true, true, Layout>
                        : bvh_walk_kernel<true, false, Layout>)
              : (compat ? bvh_walk_kernel<false, true, Layout>
                        : bvh_walk_kernel<false, false, Layout>);
  kernel<<<blocks_for(rays.n), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(tr, rays, max_leaf,
                                                stack_depth, out);
  return (int)cudaGetLastError();
}

// What the card gives an instantiation: what == 0 the registers a thread,
// 1 the blocks an SM holds at once, 2 the threads a block, 3 the bytes of
// local memory a thread.  A negative value is minus the CUDA error.
int kernel_info(const void* kernel, int what) {
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
  const PlainTree tr = {node_min, node_max, axis,   right,
                        start,    end,      indices, positions};
  return launch(tr, make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n),
                max_leaf, stack_depth, closest, compat,
                Out{t_out, tri_out, b1_out, b2_out, occ_out, stats}, stream);
}

// The same walk over the packed rows nodes8 [N, 8] and tri12 [T, 12]
// (16-byte aligned); arguments and outputs as pnrt_bvh_walk.
int pnrt_packed_walk(const float* nodes8, const float* tri12, int max_leaf,
                     int stack_depth, const float* ox, const float* oy,
                     const float* oz, const float* dx, const float* dy,
                     const float* dz, const float* t_max,
                     const uint8_t* mask, int n, int closest, int compat,
                     float* t_out, int* tri_out, float* b1_out,
                     float* b2_out, uint8_t* occ_out, int* stats,
                     void* stream) {
  if (n <= 0) return 0;
  const PackedRows tr = {nodes8, tri12};
  return launch(tr, make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n),
                max_leaf, stack_depth, closest, compat,
                Out{t_out, tri_out, b1_out, b2_out, occ_out, stats}, stream);
}

// What the card gives the walk (packed != 0: over the packed rows;
// closest != 0: the closest-hit form; compat != 0: its compat
// instantiation), as kernel_info.
int pnrt_bvh_kernel_info(int packed, int closest, int compat, int what) {
  const void* kernel =
      packed ? (compat ? bvh_kernel<true, PackedRows>(closest)
                       : bvh_kernel<false, PackedRows>(closest))
             : (compat ? bvh_kernel<true, PlainTree>(closest)
                       : bvh_kernel<false, PlainTree>(closest));
  return kernel_info(kernel, what);
}

}  // extern "C"
