// The 4-wide collect-then-test walk for Hopper (sm_90a): the walk of
// RenderConfig.traversal="wide4" (accel/traverse_wide4.py).
//
// Not a TPU kernel.  It is the port's kernel for the XLA walk of
// pnraytracing_tpu/accel/traverse_wide4.py (_phase1_collect, then
// _phase2_closest / _phase2_any; closest_hit_wide4, any_hit_wide4):
//   wide4_walk_kernel<true, C>   <- closest_hit_wide4 (phases 1 and 2)
//   wide4_walk_kernel<false, C>  <- any_hit_wide4
// C is the compat flag of that walk's `compat` argument.  As in the JAX
// walk it selects the reference's ray setup of the triangle test
// (intersect.cuh make_ray); phase 1's box tests are the clipped slab test
// in both forms, as JAX's _phase1_collect calls intersect_aabb without
// compat.
//
// What it computes, one thread a ray, step for step the JAX walk's:
//   Phase 1 pops wide node ids from the thread's stack (the root, node 0,
//   first).  Each pop reads one nodes32 row: `width` child boxes (min.xyz,
//   max.xyz) at 6k, then `width` child codes at 6*width + k (0 empty, odd
//   2*leaf + 1, even 2*(node + 1)), padded to a multiple of 8 floats.  It
//   box-tests the occupied slots against t_max (never a running best: no
//   triangle has been tested yet), pushes the internal children that pass
//   in slot order (the last pushed is popped first) and appends the leaves
//   that pass, in slot order, to the ray's buffer.  A push above
//   stack_depth is dropped and the stack's top stays at stack_depth, as
//   JAX's scatter with mode="drop" does; a leaf past leaf_buffer entries
//   is dropped and the ray marked overflowed.
//   Phase 2 tests each buffered leaf40 row in collection order: up to
//   min(max_leaf, L) triangles (L = the row's 10*L floats / 10: 9 corner
//   floats each, then their ids as floats, -1 for padding), the closest
//   form against the running best with the strict t < best rule, the any
//   form until its first hit.
//   Masked rays and rays of never_enters (intersect.cuh) walk nothing.
// An overflowed ray's answer is incomplete: the wrapper walks such rays
// again by the pop-test kernels 5 / 6 (launched unconditionally with the
// overflow as their mask, so no device value is read on the host and the
// frame stays one CUDA graph) and merges, as JAX's lax.cond fallback does.
//
// The buffer.  Phase 1 writes leaf ids into a device scratch tensor
// buf [leaf_buffer, n] int32 that the wrapper allocates: slot s of ray i
// at buf[s * n + i], so a warp's writes and reads of one slot coalesce,
// and any leaf_buffer works (a local array would cap it).
//
// Width.  Any `width` whose row is ceil(7 * width / 8) * 8 floats: 32 at
// width 4, 56 at width 8 (the wrapper checks the row length).
//
// What bounds it.  As every walk of the port (traverse.cu), the chains of
// dependent reads: a pop waits for its row before it knows its children,
// and phase 2 waits for each leaf row.  Bytes (rays in and out, each table
// once) and the slab and triangle operations are far below the time.
// Phase 1 prunes by t_max alone, so a closest-hit ray collects every leaf
// its segment crosses; that is the price of the TPU design's row economy,
// which Hopper does not need.  The design is the simple one: one loop per
// phase, the stack in local memory, no row in flight.
//
// Stats ([4, n] int32 when requested): phase-1 pops, leaves that passed
// their box test (buffered or dropped), triangle tests of phase 2 (of
// rows whose id is not padding), and the overflow flag.
//
// Arithmetic: intersect.cuh's slab and watertight tests, built with
// --fmad=false, so kernel and plain version (accel/traverse_wide4.py)
// agree bit for bit.

#include "intersect.cuh"

namespace pnrt {
namespace {

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

struct Wide4 {
  const float* nodes;  // [N4, row]
  const float* leaves; // [NL, 10 * L]
  int width, row, leaf_l;
};

struct Out {
  float* t;
  int* tri;
  float* b1;
  float* b2;
  uint8_t* occ;
  uint8_t* overflow;
  int* stats;
};

template <bool CLOSEST, bool COMPAT>
__global__ void __launch_bounds__(kThreads)
    wide4_walk_kernel(Wide4 w, Rays rays, int max_leaf, int stack_depth,
                      int leaf_buffer, int* __restrict__ buf, Out out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = rays.n;
  if (i >= n) return;
  const Ray r = make_ray<COMPAT>(rays.ox[i], rays.oy[i], rays.oz[i],
                                 rays.dx[i], rays.dy[i], rays.dz[i]);
  const float t_max = rays.t_max[i];
  int pops = 0, passed = 0, tests = 0;
  int cnt = 0;
  bool overflow = false;

  // ---- phase 1: the internal topology, leaves into the buffer
  int stack[KSTACK];
  int top = 0;
  if (walks(rays, i, r)) stack[top++] = 0;
  while (top > 0) {
    const int node = stack[--top];
    ++pops;
    const float* row = w.nodes + (int64_t)w.row * node;
    for (int k = 0; k < w.width; ++k) {
      const int code = (int)ldf(row + 6 * w.width + k);
      if (code == 0) continue;
      const float* b = row + 6 * k;
      if (!hit_aabb<false>(r, ldf(b), ldf(b + 1), ldf(b + 2), ldf(b + 3),
                           ldf(b + 4), ldf(b + 5), t_max)) {
        continue;
      }
      if (code & 1) {  // a leaf: into the buffer, or overflow
        ++passed;
        if (cnt < leaf_buffer) {
          buf[(int64_t)cnt * n + i] = (code - 1) >> 1;
          ++cnt;
        } else {
          overflow = true;
        }
      } else {  // an internal node: onto the stack unless it is full
        if (top < stack_depth) stack[top++] = (code >> 1) - 1;
      }
    }
  }

  // ---- phase 2: the buffered leaves' triangles, in collection order
  const int per_leaf = min(max_leaf, w.leaf_l);
  float t_best = t_max, b1 = 0.0f, b2 = 0.0f;
  int tri = -1;
  bool occ = false;
  for (int s = 0; s < cnt && !occ; ++s) {
    const float* lr =
        w.leaves + (int64_t)(10 * w.leaf_l) * buf[(int64_t)s * n + i];
    for (int k = 0; k < per_leaf; ++k) {
      const int tid = (int)ldf(lr + 9 * w.leaf_l + k);
      if (tid < 0) continue;  // padding
      const float* p = lr + 9 * k;
      float t, u, v;
      ++tests;
      const bool h = hit_corners(r, ldf(p), ldf(p + 1), ldf(p + 2),
                                 ldf(p + 3), ldf(p + 4), ldf(p + 5),
                                 ldf(p + 6), ldf(p + 7), ldf(p + 8),
                                 CLOSEST ? t_best : t_max, t, u, v);
      if constexpr (CLOSEST) {
        if (h && t < t_best) {
          t_best = t;
          tri = tid;
          b1 = u;
          b2 = v;
        }
      } else if (h) {
        occ = true;
        break;
      }
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
  out.overflow[i] = overflow ? 1 : 0;
  if (out.stats != nullptr) {
    out.stats[i] = pops;
    out.stats[n + i] = passed;
    out.stats[2 * n + i] = tests;
    out.stats[3 * n + i] = overflow ? 1 : 0;
  }
}

template <bool COMPAT>
const void* wide4_kernel(int closest) {
  return closest ? (const void*)wide4_walk_kernel<true, COMPAT>
                 : (const void*)wide4_walk_kernel<false, COMPAT>;
}

}  // namespace
}  // namespace pnrt

using namespace pnrt;

extern "C" {

// The 4-wide walk: nodes [N4, row] and leaves [NL, 10 * leaf_l] f32 (the
// layout's width and row length given), at most max_leaf triangles a
// leaf, a stack of stack_depth <= KSTACK entries, buf a [leaf_buffer, n]
// int32 scratch.  closest != 0 writes t / tri / b1 / b2 (t_max and -1 on a
// miss), else occ; overflow [n] always; compat != 0 launches the compat
// instantiation; stats may be null, else [4, n] int32.  Returns
// cudaGetLastError() after the launch.
int pnrt_wide4_walk(const float* nodes, const float* leaves, int width,
                    int row, int leaf_l, int max_leaf, int stack_depth,
                    int leaf_buffer, int* buf, const float* ox,
                    const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* t_max,
                    const uint8_t* mask, int n, int closest, int compat,
                    float* t_out, int* tri_out, float* b1_out, float* b2_out,
                    uint8_t* occ_out, uint8_t* overflow_out, int* stats,
                    void* stream) {
  if (n <= 0) return 0;
  const Wide4 w = {nodes, leaves, width, row, leaf_l};
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  const Out out = {t_out,  tri_out,      b1_out, b2_out,
                   occ_out, overflow_out, stats};
  auto kernel = closest ? (compat ? wide4_walk_kernel<true, true>
                                  : wide4_walk_kernel<true, false>)
                        : (compat ? wide4_walk_kernel<false, true>
                                  : wide4_walk_kernel<false, false>);
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, rays, max_leaf, stack_depth, leaf_buffer, buf, out);
  return (int)cudaGetLastError();
}

// What the card gives the walk (closest != 0: the closest-hit form;
// compat != 0: its compat instantiation): what == 0 the registers a
// thread, 1 the blocks an SM holds at once, 2 the threads a block, 3 the
// bytes of local memory a thread.  A negative value is minus the CUDA
// error.
int pnrt_wide4_kernel_info(int closest, int compat, int what) {
  const void* kernel =
      compat ? wide4_kernel<true>(closest) : wide4_kernel<false>(closest);
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
