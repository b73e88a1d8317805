// Brick-streaming BVH traversal for Hopper (sm_90a): closest hit and any
// hit over a scene cut into treelet bricks (accel/bricks.py), for scenes
// whose resident packing exceeds the budget the two packages route by
// (accel/route.py).
//
// Replaces the TPU kernel pnraytracing_tpu/accel/traverse_stream.py:
//   stream_kernel<true>   <- _make_stream_kernel(mode="closest")
//   stream_kernel<false>  <- _make_stream_kernel(mode="any")
//
// What it computes.  Phase 1 walks the small top tree (top16 [Nt, 16]
// wide rows in device memory; a negative child info -(b)-1 names brick
// b) and collects the bricks whose boxes the ray reaches within t_max.
// Phase 2 walks each collected brick: its header gives tris_off,
// tri_base and n_tris, its wide rows and leaf starts are local, and a
// hit's global triangle id is tri_base + local id.  Closest mode carries
// t_best from brick to brick; any mode stops at the first occluder.
//
// Design.  One thread per ray with its own stack, near child first by the
// ray's own direction sign, as in traverse.cu; the Pallas kernel's tile
// stack, tile direction signs and per-tile brick queue are gone.  Each
// thread keeps the set of bricks it reached as a bit mask in shared
// memory (ceil(n_bricks / 32) words per thread); the block ORs them into
// one union.  The block then visits the union's bricks in ascending
// brick id: it copies brick b from device memory into one shared-memory
// slot (float4 loads, only the words the header says are used), and the
// threads whose mask holds b walk it there.  A brick that no thread of
// the block still needs (every thread that reached it is occluded) is
// skipped.  So each ray walks its bricks in ascending id, an order that
// does not depend on the block: the plain version
// (accel/traverse_stream_cuda.py) visits them in the same order and gives
// the same t, tri and b bit for bit (--fmad=false, see intersect.cuh).
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): bytes = the rays
// in and out plus the bricks each block stages (the per-block stats
// output counts them; each staging reads up to brick_words words, from
// the 50 MB L2 when the brick array fits it); operations = the counted
// slab tests (2 per internal pop, top tree included) and triangle tests.
// Single-buffered staging: a block waits for each brick's copy before it
// walks it, and while one thread walks, the rest of the block idles; two
// resident blocks per SM (one ~96 KB slot each) overlap one block's copy
// with another's walk.  cp.async/TMA double buffering is later work.

#include "intersect.cuh"

using namespace pnrt;

namespace {

constexpr int kThreads = 128;
constexpr int kHeaderWords = 4;  // tris_off, tri_base, n_rows, n_tris

inline size_t smem_bytes(int brick_words, int n_bricks) {
  const size_t words = (size_t)((n_bricks + 31) / 32);
  return sizeof(float) * (size_t)brick_words +
         sizeof(uint32_t) * words * (kThreads + 1);
}

template <bool CLOSEST>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ top16,
              const float* __restrict__ bricks, int brick_words,
              int n_bricks, Rays rays, float* __restrict__ t_out,
              int* __restrict__ tri_out, float* __restrict__ b1_out,
              float* __restrict__ b2_out, uint8_t* __restrict__ occ_out,
              int* __restrict__ stats, int* __restrict__ block_stats) {
  extern __shared__ __align__(16) float smem[];
  const int n_words = (n_bricks + 31) >> 5;
  float* slot = smem;  // one staged brick
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + brick_words);
  uint32_t* block_union = masks + n_words * kThreads;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const bool in_range = i < rays.n;
  const bool active =
      in_range && (rays.mask == nullptr || rays.mask[i] != 0);
  Ray r = make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  float t_max = 0.0f;
  if (in_range) {
    r = make_ray(rays.ox[i], rays.oy[i], rays.oz[i], rays.dx[i], rays.dy[i],
                 rays.dz[i]);
    t_max = rays.t_max[i];
  }
  for (int w = 0; w < n_words; ++w) masks[w * kThreads + tid] = 0u;
  for (int w = tid; w < n_words; w += kThreads) block_union[w] = 0u;
  __syncthreads();

  int pops = 0, leaf_pops = 0, tri_tests = 0;
  int stack[KSTACK];
  int top = 0;

  // ---- phase 1: the top tree, against t_max -------------------------
  if (active) stack[top++] = 0;  // root row
  while (top > 0) {
    const int row = stack[--top];
    ++pops;
    int near_c, far_c;
    bool h_near, h_far;
    order_children(r, load_row<true>(top16 + 16 * (int64_t)row), t_max,
                   near_c, far_c, h_near, h_far);
    // far first, then near; a brick ref sets the ray's bit instead
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int c = side == 0 ? far_c : near_c;
      if (!(side == 0 ? h_far : h_near)) continue;
      if (c < 0) {
        const int b = -c - 1;
        masks[(b >> 5) * kThreads + tid] |= 1u << (b & 31);
      } else {
        stack[top++] = c;
      }
    }
  }
  for (int w = 0; w < n_words; ++w) {
    const uint32_t m = masks[w * kThreads + tid];
    if (m) atomicOr(&block_union[w], m);
  }
  __syncthreads();

  // ---- phase 2: the reached bricks, in ascending id -----------------
  float t_best = t_max;
  int tri_best = -1;
  float b1_best = 0.0f, b2_best = 0.0f;
  bool occ = false;
  int staged = 0;
  for (int w = 0; w < n_words; ++w) {
    uint32_t bits = block_union[w];  // the same in every thread
    const uint32_t mine_w = masks[w * kThreads + tid];
    while (bits) {
      const int bit = __ffs(bits) - 1;
      bits &= bits - 1;
      const bool need = ((mine_w >> bit) & 1u) && !occ;
      // also the barrier that ends every walk of the previous brick
      if (!__syncthreads_or(need)) continue;
      const float* src = bricks + (int64_t)(w * 32 + bit) * brick_words;
      const int used = (int)__ldg(src) + 9 * (int)__ldg(src + 3);
      const int n4 = (used + 3) >> 2;
      for (int k = tid; k < n4; k += kThreads) {
        reinterpret_cast<float4*>(slot)[k] =
            __ldg(reinterpret_cast<const float4*>(src) + k);
      }
      __syncthreads();
      ++staged;
      if (!need) continue;

      const int tris_off = (int)slot[0];
      const int tri_base = (int)slot[1];
      stack[top++] = 0;  // the brick's root row
      while (top > 0) {
        const int info = stack[--top];
        ++pops;
        if (info < 0) {
          ++leaf_pops;
          const int meta = -info - 1;
          const int start = meta >> 4;
          const int count = meta & 15;
          for (int k = 0; k < count; ++k) {
            const int ti = start + k;
            const float* p = slot + tris_off + 9 * ti;
            float t, b1, b2;
            ++tri_tests;
            if (CLOSEST) {
              if (hit_triangle<false>(r, p, t_best, t, b1, b2) &&
                  t < t_best) {
                t_best = t;
                tri_best = tri_base + ti;
                b1_best = b1;
                b2_best = b2;
              }
            } else if (hit_triangle<false>(r, p, t_max, t, b1, b2)) {
              occ = true;  // occluded: stop at once
              break;
            }
          }
          if (!CLOSEST && occ) {
            top = 0;
            break;
          }
        } else {
          push_children(r, load_row<false>(slot + kHeaderWords + 16 * info),
                        CLOSEST ? t_best : t_max, stack, top);
        }
      }
    }
  }

  if (in_range) {
    if (CLOSEST) {
      t_out[i] = t_best;
      tri_out[i] = tri_best;
      b1_out[i] = b1_best;
      b2_out[i] = b2_best;
    } else {
      occ_out[i] = occ ? 1 : 0;
    }
    write_stats(stats, rays.n, i, pops, leaf_pops, tri_tests);
  }
  if (block_stats != nullptr && tid == 0) block_stats[blockIdx.x] = staged;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the stream kernel asks for: the
// brick slot plus the per-thread brick masks and their union.  (Blocks
// hold kThreads = 128 rays, the BLOCK_RAYS of the Python wrapper.)
long long pnrt_stream_smem_bytes(int brick_words, int n_bricks) {
  return (long long)smem_bytes(brick_words, n_bricks);
}

// closest != 0: t/tri/b1/b2 outputs (occ_out unused); else occ_out.
// stats may be null, else [3, n] int32 per ray: pops (top tree and
// bricks), leaf pops, triangle tests.  block_stats may be null, else
// [ceil(n / 128)] int32: bricks each block staged.  Returns the CUDA
// error of the shared-memory opt-in or of the launch, 0 on success.
int pnrt_stream(int closest, const float* top16, const float* bricks,
                int brick_words, int n_bricks, const float* ox,
                const float* oy, const float* oz, const float* dx,
                const float* dy, const float* dz, const float* t_max,
                const uint8_t* mask, int n, float* t_out, int* tri_out,
                float* b1_out, float* b2_out, uint8_t* occ_out, int* stats,
                int* block_stats, void* stream) {
  if (n <= 0) return 0;
  const Rays rays = make_rays(ox, oy, oz, dx, dy, dz, t_max, mask, n);
  const size_t smem = smem_bytes(brick_words, n_bricks);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = closest ? stream_kernel<true> : stream_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, s>>>(top16, bricks, brick_words, n_bricks,
                                        rays, t_out, tri_out, b1_out, b2_out,
                                        occ_out, stats, block_stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
