// Treelet-entry coherence sort key for Hopper (sm_90a).
//
// Replaces the TPU kernel pnraytracing_tpu/ops/compaction.py:
// treelet_entry_key_pallas.  Per ray: the index of the nearest treelet
// AABB (of K <= 512, accel/bricks.py::treelet_cut_aabbs) whose slab the
// ray enters, i.e. the argmin over k of the clamped entry t_near among
// boxes with t_far >= t_near; K when it enters none.  Key = k*8 +
// octant(d).  The argmin keeps the FIRST minimum (strict <), like the
// Pallas fori_loop and jnp.argmin in the XLA form.
//
// What held the first form back.  It ran all K slab tests for every ray
// (98.3M tests for the flagship's 262,144 key rays at K = 375) at about
// the rate the SMs dispatch instructions: ~30 instructions a test with
// --fmad=false, none of them an FMA.  Only fewer tests could give a
// factor, and the result needs most boxes only to be ruled out.
//
// Design.  One thread per ray walks an implicit binary tree over the
// INDEX RANGES of the boxes (accel/bricks.py::treelet_index_tree: heap
// order, leaf P + k is box k, an inner row the union of the leaves under
// it, padding leaves repeat box K - 1), depth first, left child first,
// without a stack: past a row's subtree the next row is (i + 1) with its
// trailing zero bits shifted out.  A row the ray misses, or enters no
// earlier than its best entry so far, is skipped with everything under
// it.  Three facts make that exact, not approximate:
//   1. treelet_cut_aabbs returns the boxes in depth-first order of the
//      BVH, so boxes with consecutive indices are neighbours in space and
//      the union of an index range is tight.
//   2. The slab test is monotone in the box under float rounding:
//      subtracting the same o, multiplying by the same 1/d, min and max
//      all keep order.  For a union U of boxes B, by the same expression,
//      t_near(U) <= t_near(B) and t_far(U) >= t_far(B) bit for bit: a ray
//      that misses U misses every B, and enters no B before U.
//   3. The first minimum wins and t_near is clamped at 0.  Left child
//      first is ascending box index, so a range whose union is entered no
//      earlier than the best so far holds no winner, and at a best entry
//      of 0 (the ray starts inside a box, as bounce rays do) the walk
//      ends.  A padding leaf comes after the box it repeats and cannot
//      beat it.
// Each block copies the tree into shared memory once (32 KB at K > 256);
// a row is two float4.  Compiled with --fmad=false, so t_near equals the
// plain PyTorch versions (ops/compaction.py::treelet_entry_key over all K
// boxes, entry_key_walk over this walk) bit for bit; fmaxf / fminf drop a
// NaN where torch keeps it, so the rays whose every test is a NaN
// (ops/compaction.py::never_enters) are keyed K up front and no other ray
// produces one.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6): on the
// flagship's 262,144 bounce-0 key rays a ray runs 23 tests instead of 375
// and a warp as many as its longest lane, 54 in the mean (SIMT efficiency
// 0.43); 0.039 ms against 0.133 for all K boxes over the same rows.  What
// holds it back now: a warp's longest lane, and ~52 instructions an
// iteration (the test, the row index, the leaf / inner branch).  Measured
// beside it and not kept: unions of flat groups of 8 / 16 / 32 consecutive
// boxes (uniform control and broadcast loads, but a warp runs 100-170
// tests: 0.049 / 0.060 / 0.069 ms), the rows read from device memory
// instead of the shared copy (within 3%, slower on two of three ray
// sets), blocks of 128 threads (11% slower) and of 512 (5% faster to 2%
// slower), the leaf / inner cases by selects instead of a branch (9%
// slower).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float safe_inv(float d) {
  return (d >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d), 1e-20f);
}

constexpr int kThreads = 256;

struct KeyRay {
  float ox, oy, oz, ix, iy, iz;
};

// The slab test of ray r against the box [lo.xyz, hi.xyz]: true when the
// ray enters it (t_far >= t_near), with its entry t clamped at 0.
__device__ __forceinline__ bool enters(const KeyRay& r, const float4& lo,
                                       const float4& hi, float& t_near) {
  const float nx = (lo.x - r.ox) * r.ix;
  const float ny = (lo.y - r.oy) * r.iy;
  const float nz = (lo.z - r.oz) * r.iz;
  const float fx = (hi.x - r.ox) * r.ix;
  const float fy = (hi.y - r.oy) * r.iy;
  const float fz = (hi.z - r.oz) * r.iz;
  const float t_far =
      fminf(fminf(fmaxf(fx, nx), fmaxf(fy, ny)), fmaxf(fz, nz));
  t_near = fmaxf(fmaxf(fminf(fx, nx), fminf(fy, ny)),
                 fmaxf(fminf(fz, nz), 0.0f));
  return t_far >= t_near;
}

// True when every test of this ray is a NaN (never_enters of
// ops/compaction.py).
__device__ __forceinline__ bool never_enters(float o, float d) {
  return isnan(o) || isnan(d) || (isinf(o) && isinf(d));
}

__global__ void __launch_bounds__(kThreads)
entry_key_kernel(const float4* __restrict__ table, int n_rows, int p,
                 int k_total, const float* __restrict__ ox,
                 const float* __restrict__ oy, const float* __restrict__ oz,
                 const float* __restrict__ dx, const float* __restrict__ dy,
                 const float* __restrict__ dz, int n,
                 int* __restrict__ key_out, int* __restrict__ counts) {
  extern __shared__ float4 rows[];
  for (int j = threadIdx.x; j < 2 * n_rows; j += blockDim.x) {
    rows[j] = table[j];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
  KeyRay r;
  r.ox = ox[i];
  r.oy = oy[i];
  r.oz = oz[i];
  r.ix = safe_inv(rdx);
  r.iy = safe_inv(rdy);
  r.iz = safe_inv(rdz);
  float best_t = 3e38f;
  int best_k = k_total;
  int unions = 0, members = 0;
  if (!(never_enters(r.ox, rdx) || never_enters(r.oy, rdy) ||
        never_enters(r.oz, rdz))) {
    int node = 1;
    do {
      float t_near;
      const bool enter =
          enters(r, rows[2 * node], rows[2 * node + 1], t_near) &&
          t_near < best_t;
      const int past = (node + 1) >> (__ffs(node + 1) - 1);
      if (node >= p) {
        ++members;
        if (enter) {
          best_t = t_near;
          best_k = node - p;
          if (t_near == 0.0f) break;
        }
        node = past;
      } else {
        ++unions;
        node = enter ? 2 * node : past;
      }
    } while (node != 1);
  }
  const int oct = (rdx > 0.0f ? 4 : 0) + (rdy > 0.0f ? 2 : 0) +
                  (rdz > 0.0f ? 1 : 0);
  key_out[i] = best_k * 8 + oct;
  if (counts != nullptr) {
    counts[i] = unions;
    counts[n + i] = members;
  }
}

}  // namespace

extern "C" {

// table: [n_rows, 8] f32 rows (16-byte aligned); p: the tree's leaf count
// (row p + k is box k).  counts may be null, else [2, n] int32: union and
// member tests.  Returns cudaGetLastError() after the launch.
int pnrt_entry_key(const float* table, int n_rows, int p, int k_total,
                   const float* ox, const float* oy, const float* oz,
                   const float* dx, const float* dy, const float* dz, int n,
                   int* key_out, int* counts, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float4) * 2 * (size_t)n_rows;
  entry_key_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), n_rows, p, k_total, ox, oy, oz,
      dx, dy, dz, n, key_out, counts);
  return (int)cudaGetLastError();
}

// what == 0 the registers a thread, 1 the blocks an SM holds at once with
// smem_bytes of shared memory a block, 2 the threads a block.  A negative
// value is minus the CUDA error.
int pnrt_entry_key_kernel_info(int what, int smem_bytes) {
  if (what == 2) return kThreads;
  if (what == 1) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, entry_key_kernel, kThreads, (size_t)smem_bytes);
    return err == cudaSuccess ? blocks : -(int)err;
  }
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, entry_key_kernel);
  return err == cudaSuccess ? a.numRegs : -(int)err;
}

}  // extern "C"
