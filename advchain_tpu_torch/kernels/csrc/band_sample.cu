// Bilinear corner sampler for Hopper (sm_90a): the forward gather with its
// weighted sum, and the backward scatter with the weight gradient.
//
// Replaces the TPU kernels advchain_tpu/kernels/gather_matmul.py::band_gather
// (forward of _weighted_band_sample) and ::band_scatter (its backward,
// _wbs_bwd).  The TPU versions gather through a one-hot matrix product on the
// MXU, split f32 into bf16 pieces and walk row bands held in VMEM; none of
// that is needed here: each thread reads its four corners from device memory
// directly, in f32.
//
// Contract (shared with the plain PyTorch versions in band_sample.py):
//   img (N, C, H, W) f32, yidx/xidx (N, P) i32 (the clipped base corner),
//   w (N, 4, P) f32 in corner order (0,0) (0,1) (1,0) (1,1).
//   out[n,c,p] = sum_k w[n,k,p] * img[n, c, y+dy_k, x+dx_k]
//   A tap outside [0,H) x [0,W) reads zero and receives no gradient (the
//   caller folds collapsed border taps into the weights).
//
// Bound: both kernels are memory-bound gathers (7 and ~16 flops per
// (n, c, p) against at least 8 bytes moved).  At the headline shapes of the
// scaling-and-squaring compositions (N=128, C=2, H=W=192, P=H*W) the forward
// must move img + indices + weights + out = 37.7 + 37.7 + 75.5 + 37.7 MB =
// 189 MB, 0.056 ms at 3.35 TB/s; the backward moves g + img + indices +
// weights + d_img + d_w = 302 MB, 0.090 ms.  Design: one thread per output pixel (n, p), so a warp's 32
// threads read neighbouring indices and weights and, for the near-identity
// warps that dominate the path, neighbouring image pixels; the four weights
// and indices are loaded once and reused across the C channels.  The
// backward re-gathers the corners instead of reading a saved (N, 4, C, P)
// tensor and adds into d_img with atomics, so its sum order is not fixed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Taps {
  int64_t off[4];
  bool ok[4];
};

__device__ __forceinline__ Taps corner_taps(int y, int x, int h, int w) {
  Taps t;
  const bool y0 = y >= 0 && y < h, y1 = y + 1 >= 0 && y + 1 < h;
  const bool x0 = x >= 0 && x < w, x1 = x + 1 >= 0 && x + 1 < w;
  const int64_t base = (int64_t)y * w + x;
  t.off[0] = base;         t.ok[0] = y0 && x0;
  t.off[1] = base + 1;     t.ok[1] = y0 && x1;
  t.off[2] = base + w;     t.ok[2] = y1 && x0;
  t.off[3] = base + w + 1; t.ok[3] = y1 && x1;
  return t;
}

__global__ void __launch_bounds__(kThreads)
band_sample_fwd_kernel(const float* __restrict__ img,
                       const int* __restrict__ yidx,
                       const int* __restrict__ xidx,
                       const float* __restrict__ wts,
                       float* __restrict__ out,
                       int n, int c, int h, int w, int p) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)n * p) return;
  const int64_t ni = t / p, pi = t - ni * p;
  const Taps tap = corner_taps(yidx[t], xidx[t], h, w);
  const float* wp = wts + ni * 4 * p + pi;
  const float w0 = wp[0], w1 = wp[p], w2 = wp[2 * (int64_t)p],
              w3 = wp[3 * (int64_t)p];
  const int64_t hw = (int64_t)h * w;
  const float* src = img + ni * c * hw;
  float* dst = out + ni * c * p + pi;
  for (int ci = 0; ci < c; ++ci) {
    const float* s = src + ci * hw;
    const float v0 = tap.ok[0] ? s[tap.off[0]] : 0.f;
    const float v1 = tap.ok[1] ? s[tap.off[1]] : 0.f;
    const float v2 = tap.ok[2] ? s[tap.off[2]] : 0.f;
    const float v3 = tap.ok[3] ? s[tap.off[3]] : 0.f;
    // k = 0..3 in order, each product rounded: the plain version's sum
    float acc = __fmul_rn(w0, v0);
    acc = __fadd_rn(acc, __fmul_rn(w1, v1));
    acc = __fadd_rn(acc, __fmul_rn(w2, v2));
    acc = __fadd_rn(acc, __fmul_rn(w3, v3));
    dst[ci * (int64_t)p] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
band_sample_bwd_kernel(const float* __restrict__ g,
                       const float* __restrict__ img,
                       const int* __restrict__ yidx,
                       const int* __restrict__ xidx,
                       const float* __restrict__ wts,
                       float* __restrict__ d_img,
                       float* __restrict__ d_w,
                       int n, int c, int h, int w, int p) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)n * p) return;
  const int64_t ni = t / p, pi = t - ni * p;
  const Taps tap = corner_taps(yidx[t], xidx[t], h, w);
  const float* wp = wts + ni * 4 * p + pi;
  const float wk[4] = {wp[0], wp[p], wp[2 * (int64_t)p], wp[3 * (int64_t)p]};
  const int64_t hw = (int64_t)h * w;
  const float* src = img + ni * c * hw;
  float* dsrc = d_img + ni * c * hw;
  const float* gp = g + ni * c * p + pi;
  float dw[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ci = 0; ci < c; ++ci) {
    const float gv = gp[ci * (int64_t)p];
    const float* s = src + ci * hw;
    float* ds = dsrc + ci * hw;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!tap.ok[k]) continue;
      dw[k] += gv * s[tap.off[k]];
      const float contrib = wk[k] * gv;
      if (contrib != 0.f) atomicAdd(ds + tap.off[k], contrib);
    }
  }
  float* dwp = d_w + ni * 4 * p + pi;
#pragma unroll
  for (int k = 0; k < 4; ++k) dwp[k * (int64_t)p] = dw[k];
}

int blocks_for(int n, int p) {
  return (int)(((int64_t)n * p + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int advchain_band_sample_fwd(const float* img, const int* yidx,
                             const int* xidx, const float* w, float* out,
                             int n, int c, int h, int wd, int p,
                             void* stream) {
  if ((int64_t)n * p > 0) {
    band_sample_fwd_kernel<<<blocks_for(n, p), kThreads, 0,
                             (cudaStream_t)stream>>>(img, yidx, xidx, w, out,
                                                     n, c, h, wd, p);
  }
  return (int)cudaGetLastError();
}

// d_img must be zeroed by the caller; d_w is fully written.
int advchain_band_sample_bwd(const float* g, const float* img,
                             const int* yidx, const int* xidx,
                             const float* w, float* d_img, float* d_w,
                             int n, int c, int h, int wd, int p,
                             void* stream) {
  if ((int64_t)n * p > 0) {
    band_sample_bwd_kernel<<<blocks_for(n, p), kThreads, 0,
                             (cudaStream_t)stream>>>(g, img, yidx, xidx, w,
                                                     d_img, d_w, n, c, h, wd,
                                                     p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
