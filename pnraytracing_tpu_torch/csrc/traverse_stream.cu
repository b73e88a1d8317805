// Brick-streaming BVH traversal for Hopper (sm_90a): closest hit and any
// hit over a scene cut into treelet bricks (accel/bricks.py), for scenes
// whose resident packing exceeds the budget the two packages route by
// (accel/route.py).
//
// Replaces the TPU kernel pnraytracing_tpu/accel/traverse_stream.py:
//   stream_kernel<true, C>   <- _make_stream_kernel(mode="closest")
//   stream_kernel<false, C>  <- _make_stream_kernel(mode="any")
// C is the kernel's compile-time `compat` (intersect.cuh): with it the top
// tree's and the bricks' slab tests are the reference's interval-free
// t1 >= t0, so a closest walk enters every brick the ray's line crosses.
//
// What it computes.  The top tree (top16 [Nt, 16] wide rows; a negative
// child info -(b)-1 names brick b) leads to the bricks ([B, brick_words]
// blobs: a header tris_off, tri_base, n_rows, n_tris, then local wide
// rows, then local tri9 rows).  A hit's global triangle id is tri_base +
// local id.  Closest mode returns the nearest hit within t_max, any mode
// whether anything is hit within t_max.
//
// Design.  One thread per ray, one stack, one walk, everything read where
// it lies in device memory.  Popping a top row slab-tests both children
// (against t_best in closest mode, t_max in any mode) and pushes the hit
// ones, far first, so the near child pops next.  Popping a brick ref
// enters that brick at once: the thread keeps the brick's row base,
// tris_off and tri_base in registers, remembers the stack level, and
// walks the brick's local rows and triangles exactly as traverse.cu walks
// a resident scene, until the stack is back at the remembered level; then
// it is in the top tree again.  Inside a brick a negative entry is a leaf
// (start << 4 | count), outside it a brick ref: the level tells which.
// So a ray visits its bricks near first and never enters a brick whose
// box lies behind the hit it already has.  There is no shared memory, no
// barrier and no per-block state; rays of a warp that sit in different
// bricks read different addresses.  The plain version
// (accel/traverse_stream_cuda.py) walks in the same order and gives the
// same t, tri, b and stats bit for bit (--fmad=false, see intersect.cuh);
// both give a ray of never_enters (intersect.cuh) no pop at all.
//
// Why the bricks are not staged.  The Pallas kernel pages each brick
// through fast scalar memory because Mosaic cannot index device memory
// per lane; Hopper can.  An earlier version of this kernel copied every
// brick a block of 128 rays reached into a 95.5 KB shared-memory slot:
// on the 102,404-triangle scene that moved 6-7 KB a ray where the walks
// read 1-3 KB, held two blocks an SM and cost 0.6027 ms (closest, 262,144
// rays) and 0.8106 ms (any, 524,288 rays) against 0.1044 / 0.1280 ms of
// the resident walk on the same rays (NVIDIA H100 80GB HBM3, 700.00 W).
// This kernel takes 0.1143 / 0.1318 ms there, 1.09x / 0.99x the resident
// walk in its own run (0.1051 / 0.1334 ms), and 0.1137 / 0.1337 ms on
// 96 KB bricks (chip_smoke.py from a git archive of the tree, same card
// and limit; PERF.md section 6).
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): bytes = the rays
// in and out plus the top tree and the brick array once; operations =
// the counted slab tests (2 per internal pop) and triangle tests.  Both
// are ~0.01 ms at those shapes; the expected limiter is the one of
// traverse.cu, warp divergence and dependent L2 reads of the per-thread
// walk.
//
// Measured and not kept (same card; PERF.md section 6): blocks of
// 64 and 256 threads ran within 4% of 128 (256 faster on closest, slower
// on any); a top tree copied into shared memory once a block ran 11%
// (closest) and 25% (any) slower, the scene's 57 top rows being hot in L1
// anyway, for 18-28 more registers.  So the top tree is read in place and
// the kernel uses no shared memory at all.

#include "intersect.cuh"

using namespace pnrt;

namespace {

constexpr int kThreads = 128;
constexpr int kHeaderWords = 4;  // tris_off, tri_base, n_rows, n_tris

template <bool CLOSEST, bool COMPAT>
__global__ void __launch_bounds__(kThreads, 4)
stream_kernel(const float* __restrict__ top16,
              const float* __restrict__ bricks, int brick_words, Rays rays,
              int max_leaf, float* __restrict__ t_out, int* __restrict__ tri_out,
              float* __restrict__ b1_out, float* __restrict__ b2_out,
              uint8_t* __restrict__ occ_out, int* __restrict__ stats) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rays.n) return;
  const Ray r = make_ray<COMPAT>(rays.ox[i], rays.oy[i], rays.oz[i],
                                 rays.dx[i], rays.dy[i], rays.dz[i]);
  const bool active = walks(rays, i, r);
  const float t_max = rays.t_max[i];
  float t_best = t_max;
  int tri_best = -1;
  float b1_best = 0.0f, b2_best = 0.0f;
  bool occ = false;
  int pops = 0, leaf_pops = 0, tri_tests = 0, entered = 0;

  int stack[KSTACK];
  int top = 0;
  if (active) stack[top++] = 0;  // top row 0
  // where the walk is: level < 0 in the top tree (rows = top16), else in
  // the brick entered at stack level `level` (rows = its local rows)
  int level = -1;
  const float* rows = top16;
  const float* tris = nullptr;
  int tri_base = 0;
  while (top > 0) {
    if (top == level) {  // the brick's entries are used up
      level = -1;
      rows = top16;
    }
    int info = stack[--top];
    ++pops;
    if (info < 0) {
      if (level >= 0) {  // a leaf of the brick
        ++leaf_pops;
        const int meta = -info - 1;
        const int start = meta >> 4;
        const int count = min(meta & 15, max_leaf);
        for (int k = 0; k < count; ++k) {
          const int ti = start + k;
          float t, b1, b2;
          ++tri_tests;
          if (CLOSEST) {
            if (hit_triangle(r, tris + 9 * ti, t_best, t, b1, b2) &&
                t < t_best) {
              t_best = t;
              tri_best = tri_base + ti;
              b1_best = b1;
              b2_best = b2;
            }
          } else if (hit_triangle(r, tris + 9 * ti, t_max, t, b1, b2)) {
            occ = true;  // occluded: stop at once
            break;
          }
        }
        if (!CLOSEST && occ) break;
        continue;
      }
      // a brick ref: enter the brick, this pop is its row 0
      const float* base = bricks + (int64_t)(-info - 1) * brick_words;
      const float4 head = ldf4(base);
      rows = base + kHeaderWords;
      tris = base + (int)head.x;
      tri_base = (int)head.y;
      level = top;
      info = 0;
      ++entered;
    }
    const float t_lim = CLOSEST ? t_best : t_max;
    push_children<COMPAT>(r, load_row(rows + 16 * (int64_t)info), t_lim,
                          stack, top);
  }

  if (CLOSEST) {
    t_out[i] = t_best;
    tri_out[i] = tri_best;
    b1_out[i] = b1_best;
    b2_out[i] = b2_best;
  } else {
    occ_out[i] = occ ? 1 : 0;
  }
  write_stats(stats, rays.n, i, pops, leaf_pops, tri_tests);
  if (stats != nullptr) stats[3 * (int64_t)rays.n + i] = entered;
}

// The instantiation of one mode of the kernel.
using StreamKernel = void (*)(const float*, const float*, int, Rays, int,
                              float*, int*, float*, float*, uint8_t*, int*);

StreamKernel stream_kernel_of(int closest, int compat) {
  return closest ? (compat ? stream_kernel<true, true>
                           : stream_kernel<true, false>)
                 : (compat ? stream_kernel<false, true>
                           : stream_kernel<false, false>);
}

}  // namespace

extern "C" {

// closest != 0: t/tri/b1/b2 outputs (occ_out unused); else occ_out.
// compat != 0 launches the compat instantiation; at most max_leaf
// triangles of a leaf are tested (RenderConfig.max_leaf_size, the cap of
// the Pallas kernel's leaf loop).  stats may be null, else [4, n] int32
// per ray: pops (top tree and bricks), leaf pops, triangle tests, bricks
// entered.  Returns cudaGetLastError() after the launch.
int pnrt_stream(int closest, int compat, int max_leaf, const float* top16,
                const float* bricks, int brick_words, const float* ox,
                const float* oy, const float* oz, const float* dx,
                const float* dy, const float* dz, const float* t_max,
                const uint8_t* mask, int n, float* t_out, int* tri_out,
                float* b1_out, float* b2_out, uint8_t* occ_out, int* stats,
                void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StreamKernel kernel = stream_kernel_of(closest, compat);
  kernel<<<blocks, kThreads, 0, s>>>(top16, bricks, brick_words, rays,
                                     max_leaf, t_out, tri_out, b1_out,
                                     b2_out, occ_out, stats);
  return (int)cudaGetLastError();
}

// What the card gives one instantiation: what == 0 the registers a
// thread, what == 1 the blocks an SM can hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), what == 2 the threads
// a block.  A negative value is minus the CUDA error.
int pnrt_stream_kernel_info(int closest, int compat, int what) {
  const StreamKernel kernel = stream_kernel_of(closest, compat);
  if (what == 2) return kThreads;
  if (what == 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    return err == cudaSuccess ? attr.numRegs : -(int)err;
  }
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kThreads, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"
