// Trilinear corner sampler for Hopper (sm_90a): the forward gather of the
// eight corners with its weighted sum, and the backward scatter with the
// weight gradient.
//
// Replaces the TPU kernels advchain_tpu/kernels/gather_matmul.py::zband_gather
// (forward of _weighted_zband_sample) and ::zband_scatter (its backward,
// _wzs_bwd).  The TPU versions gather through a one-hot x matrix on the MXU
// over (z, y-band) blocks of a K=2 x-shifted stack held in VMEM or streamed
// from HBM, with bf16 value splits and channel groups; none of that is
// needed here: each thread reads its eight corners from device memory
// directly, in f32.
//
// Contract (shared with the plain PyTorch versions in zband_sample.py):
//   img (N, C, D, H, W) f32, zidx/yidx/xidx (N, P) i32 (the clipped base
//   corner), w (N, 8, P) f32 in (dz, dy, dx) binary corner order,
//   k = 4*dz + 2*dy + dx.
//   out[n,c,p] = sum_k w[n,k,p] * img[n, c, z+dz_k, y+dy_k, x+dx_k]
//   A tap outside [0,D) x [0,H) x [0,W) reads zero and receives no gradient
//   (the caller folds collapsed border taps into the weights).
//
// Bound: both kernels are memory-bound gathers (15 and ~32 flops per
// (n, c, p) against at least 8 bytes moved).  At the 3D episode's flow
// compositions (N=2, C=3, 12x192x192, P=D*H*W) the forward must move
// img + indices + weights + out = 10.6 + 10.6 + 28.3 + 10.6 MB = 60.2 MB,
// 0.018 ms at 3.35 TB/s.  Design: one thread per output voxel (n, p), so a
// warp's 32 threads read neighbouring indices and weights and, for the
// near-identity warps, neighbouring voxels of two planes; the eight weights
// and offsets are loaded once and reused across the C channels.  The
// backward re-gathers the corners instead of reading a saved (N, 8, C, P)
// tensor and adds into d_img with atomics (skipping zero contributions, the
// folded border taps), so its sum order is not fixed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Taps {
  int64_t off[8];
  bool ok[8];
};

__device__ __forceinline__ Taps corner_taps(int z, int y, int x, int d, int h,
                                            int w) {
  Taps t;
  const bool zs[2] = {z >= 0 && z < d, z + 1 >= 0 && z + 1 < d};
  const bool ys[2] = {y >= 0 && y < h, y + 1 >= 0 && y + 1 < h};
  const bool xs[2] = {x >= 0 && x < w, x + 1 >= 0 && x + 1 < w};
  const int64_t hw = (int64_t)h * w;
  const int64_t base = ((int64_t)z * h + y) * w + x;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    t.off[k] = base + dz * hw + dy * (int64_t)w + dx;
    t.ok[k] = zs[dz] && ys[dy] && xs[dx];
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
zband_sample_fwd_kernel(const float* __restrict__ img,
                        const int* __restrict__ zidx,
                        const int* __restrict__ yidx,
                        const int* __restrict__ xidx,
                        const float* __restrict__ wts,
                        float* __restrict__ out,
                        int n, int c, int d, int h, int w, int p) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)n * p) return;
  const int64_t ni = t / p, pi = t - ni * p;
  const Taps tap = corner_taps(zidx[t], yidx[t], xidx[t], d, h, w);
  const float* wp = wts + ni * 8 * p + pi;
  float wk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) wk[k] = wp[k * (int64_t)p];
  const int64_t dhw = (int64_t)d * h * w;
  const float* src = img + ni * c * dhw;
  float* dst = out + ni * c * p + pi;
  for (int ci = 0; ci < c; ++ci) {
    const float* s = src + ci * dhw;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = tap.ok[k] ? s[tap.off[k]] : 0.f;
    // k = 0..7 in order, each product rounded: the plain version's sum
    float acc = __fmul_rn(wk[0], v[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(wk[k], v[k]));
    dst[ci * (int64_t)p] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
zband_sample_bwd_kernel(const float* __restrict__ g,
                        const float* __restrict__ img,
                        const int* __restrict__ zidx,
                        const int* __restrict__ yidx,
                        const int* __restrict__ xidx,
                        const float* __restrict__ wts,
                        float* __restrict__ d_img,
                        float* __restrict__ d_w,
                        int n, int c, int d, int h, int w, int p) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)n * p) return;
  const int64_t ni = t / p, pi = t - ni * p;
  const Taps tap = corner_taps(zidx[t], yidx[t], xidx[t], d, h, w);
  const float* wp = wts + ni * 8 * p + pi;
  float wk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) wk[k] = wp[k * (int64_t)p];
  const int64_t dhw = (int64_t)d * h * w;
  const float* src = img + ni * c * dhw;
  float* dsrc = d_img + ni * c * dhw;
  const float* gp = g + ni * c * p + pi;
  float dw[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ci = 0; ci < c; ++ci) {
    const float gv = gp[ci * (int64_t)p];
    const float* s = src + ci * dhw;
    float* ds = dsrc + ci * dhw;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!tap.ok[k]) continue;
      dw[k] += gv * s[tap.off[k]];
      const float contrib = wk[k] * gv;
      if (contrib != 0.f) atomicAdd(ds + tap.off[k], contrib);
    }
  }
  float* dwp = d_w + ni * 8 * p + pi;
#pragma unroll
  for (int k = 0; k < 8; ++k) dwp[k * (int64_t)p] = dw[k];
}

int blocks_for(int n, int p) {
  return (int)(((int64_t)n * p + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int advchain_zband_sample_fwd(const float* img, const int* zidx,
                              const int* yidx, const int* xidx,
                              const float* w, float* out, int n, int c, int d,
                              int h, int wd, int p, void* stream) {
  if ((int64_t)n * p > 0) {
    zband_sample_fwd_kernel<<<blocks_for(n, p), kThreads, 0,
                              (cudaStream_t)stream>>>(img, zidx, yidx, xidx,
                                                      w, out, n, c, d, h, wd,
                                                      p);
  }
  return (int)cudaGetLastError();
}

// d_img must be zeroed by the caller; d_w is fully written.
int advchain_zband_sample_bwd(const float* g, const float* img,
                              const int* zidx, const int* yidx,
                              const int* xidx, const float* w, float* d_img,
                              float* d_w, int n, int c, int d, int h, int wd,
                              int p, void* stream) {
  if ((int64_t)n * p > 0) {
    zband_sample_bwd_kernel<<<blocks_for(n, p), kThreads, 0,
                              (cudaStream_t)stream>>>(g, img, zidx, yidx,
                                                      xidx, w, d_img, d_w, n,
                                                      c, d, h, wd, p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
