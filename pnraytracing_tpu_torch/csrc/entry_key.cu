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
// Design.  One thread per ray.  Each block copies the [K, 6] table into
// shared memory once (<= 12 KB at K = 512); every thread then reads the
// same box at the same time (a broadcast, no bank conflicts).  Compiled
// with --fmad=false, like traverse.cu, so t_near equals the plain
// PyTorch version (ops/compaction.py::treelet_entry_key) bit for bit.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): 6 input words
// and 1 output word per ray against K slab tests of ~25 flops per ray —
// at K = 375 the operation side is far larger, so it is compute bound.
// Warp divergence is small here (every lane runs the same K iterations);
// a later PR could cut the work with a coarse top-level box test.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float safe_inv(float d) {
  return (d >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(d), 1e-20f);
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
entry_key_kernel(const float* __restrict__ treelets, int k_total,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 int n, int* __restrict__ key_out) {
  extern __shared__ float tre[];
  for (int j = threadIdx.x; j < 6 * k_total; j += blockDim.x) {
    tre[j] = treelets[j];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float rox = ox[i], roy = oy[i], roz = oz[i];
  const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
  const float ix = safe_inv(rdx), iy = safe_inv(rdy), iz = safe_inv(rdz);
  float best_t = 3e38f;
  int best_k = k_total;
  for (int k = 0; k < k_total; ++k) {
    const float* b = tre + 6 * k;
    const float nx = (b[0] - rox) * ix;
    const float ny = (b[1] - roy) * iy;
    const float nz = (b[2] - roz) * iz;
    const float fx = (b[3] - rox) * ix;
    const float fy = (b[4] - roy) * iy;
    const float fz = (b[5] - roz) * iz;
    const float t_far =
        fminf(fminf(fmaxf(fx, nx), fmaxf(fy, ny)), fmaxf(fz, nz));
    const float t_near = fmaxf(fmaxf(fminf(fx, nx), fminf(fy, ny)),
                               fmaxf(fminf(fz, nz), 0.0f));
    if (t_far >= t_near && t_near < best_t) {
      best_t = t_near;
      best_k = k;
    }
  }
  const int oct = (rdx > 0.0f ? 4 : 0) + (rdy > 0.0f ? 2 : 0) +
                  (rdz > 0.0f ? 1 : 0);
  key_out[i] = best_k * 8 + oct;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch.
int pnrt_entry_key(const float* treelets, int k_total, const float* ox,
                   const float* oy, const float* oz, const float* dx,
                   const float* dy, const float* dz, int n, int* key_out,
                   void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * 6 * (size_t)k_total;
  entry_key_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      treelets, k_total, ox, oy, oz, dx, dy, dz, n, key_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
