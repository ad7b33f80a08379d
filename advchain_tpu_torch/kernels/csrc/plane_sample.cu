// Flat-index corner and plane samplers for Hopper (sm_90a): the forward
// gather with its weighted sum, and the backward scatter with the weight
// gradient, for K <= 4 static non-negative tap offsets.
//
// Replaces the TPU kernels advchain_tpu/kernels/gather_matmul.py::
// corner_gather (with _corner_gather_streamed), ::corner_scatter (with
// _corner_scatter_resident and _corner_scatter_chunk_major), ::plane_gather
// and ::plane_scatter (with _plane_scatter_streamed): the forward and the
// backward of _weighted_corner_sample (the 2D sampler with
// ADVCHAIN_BAND_KERNEL=0) and of _weighted_plane_sample (the 3D sampler with
// ADVCHAIN_ZBAND=0).  The corner pair is the plane pair with one plane, so
// one kernel pair serves both: a null zidx means plane 0.  The TPU versions
// stack K pre-shifted copies of the image, gather through one-hot MXU
// matmuls with f32 split into bf16 pieces, and come in VMEM-resident,
// HBM-streamed and chunk-major variants; none of that is needed here: each
// thread reads its K taps from device memory directly, in f32.
//
// Contract (shared with the plain PyTorch versions in plane_sample.py):
//   img (N, C, D, HW) f32 (D = 1 for the corner pair), zidx (N, P) i32 or
//   null, yxidx (N, P) i32, w (N, K, P) f32, offsets off[0..K-1] >= 0.
//   out[n,c,p] = sum_k w[n,k,p] * img[n, c, z, yx + off[k]]
//   A tap reads zero and receives no gradient when yx + off[k] falls outside
//   [0, HW) or z outside [0, D): the zero padding past each plane's flat end
//   that the TPU kernels read (a shift never bleeds into the next plane).
//   Inside [0, HW) the +1 tap of a row's last pixel is the next row's first
//   pixel; the samplers give that tap weight 0.
//   The forward sums k = 0..K-1 in order with each product rounded
//   (__fmul_rn / __fadd_rn, so nvcc does not contract them into FMAs): it
//   equals the plain version bit for bit.
//
// Bound: both kernels are memory-bound gathers (2K - 1 flops per (n, c, p)
// forward, about 4K backward, against at least 8 bytes moved).  At the 2D
// episode's image warps (N=128, C=1, 192x192, K=4) the forward must move
// img + idx + w + out = 18.9 + 18.9 + 75.5 + 18.9 MB = 132 MB, 0.039 ms at
// 3.35 TB/s.  Design: one thread per output point (n, p); its K weights and
// offsets are loaded once and reused across the C channels, and a warp's
// threads read neighbouring indices and weights and, for the near-identity
// and rotation warps of the path, neighbouring pixels, so the image stays in
// L2.  The backward re-gathers the taps instead of reading a saved
// (N, K, C, P) tensor; d_w needs no atomics (one writer per point), d_img is
// zeroed by the caller and filled by atomicAdd, skipping zero contributions,
// so its sum order is not fixed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 4;

struct Offsets {
  int v[kMaxTaps];
};

struct Taps {
  int64_t off[kMaxTaps];  // flat offset inside the sample's (C, D*HW) block
  bool ok[kMaxTaps];
  float w[kMaxTaps];
};

__device__ __forceinline__ Taps point_taps(const int* zidx, const int* yxidx,
                                           const float* wts, int64_t t,
                                           int64_t ni, int64_t pi, int d,
                                           int hw, int p, int k,
                                           const Offsets& offs) {
  const int z = zidx ? zidx[t] : 0;
  const bool zok = z >= 0 && z < d;
  const int64_t yx = yxidx[t];
  const float* wp = wts + ni * k * (int64_t)p + pi;
  Taps tp;
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) {
    const int64_t f = yx + offs.v[j];
    tp.ok[j] = j < k && zok && f >= 0 && f < hw;
    tp.off[j] = (int64_t)z * hw + f;
    tp.w[j] = j < k ? wp[j * (int64_t)p] : 0.f;
  }
  return tp;
}

__global__ void __launch_bounds__(kThreads)
plane_sample_fwd_kernel(const float* __restrict__ img,
                        const int* __restrict__ zidx,
                        const int* __restrict__ yxidx,
                        const float* __restrict__ wts,
                        float* __restrict__ out,
                        int n, int c, int d, int hw, int p, int k,
                        Offsets offs) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)n * p) return;
  const int64_t ni = t / p, pi = t - ni * p;
  const Taps tp = point_taps(zidx, yxidx, wts, t, ni, pi, d, hw, p, k, offs);
  const int64_t plane_len = (int64_t)d * hw;
  const float* src = img + ni * c * plane_len;
  float* dst = out + ni * c * (int64_t)p + pi;
  for (int ci = 0; ci < c; ++ci) {
    const float* s = src + ci * plane_len;
    // k = 0..K-1 in order, each product rounded: the plain version's sum
    float acc = __fmul_rn(tp.w[0], tp.ok[0] ? s[tp.off[0]] : 0.f);
#pragma unroll
    for (int j = 1; j < kMaxTaps; ++j) {
      if (j < k) {
        acc = __fadd_rn(acc, __fmul_rn(tp.w[j], tp.ok[j] ? s[tp.off[j]]
                                                         : 0.f));
      }
    }
    dst[ci * (int64_t)p] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
plane_sample_bwd_kernel(const float* __restrict__ g,
                        const float* __restrict__ img,
                        const int* __restrict__ zidx,
                        const int* __restrict__ yxidx,
                        const float* __restrict__ wts,
                        float* __restrict__ d_img,
                        float* __restrict__ d_w,
                        int n, int c, int d, int hw, int p, int k,
                        Offsets offs) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)n * p) return;
  const int64_t ni = t / p, pi = t - ni * p;
  const Taps tp = point_taps(zidx, yxidx, wts, t, ni, pi, d, hw, p, k, offs);
  const int64_t plane_len = (int64_t)d * hw;
  const float* src = img + ni * c * plane_len;
  float* dsrc = d_img + ni * c * plane_len;
  const float* gp = g + ni * c * (int64_t)p + pi;
  float dw[kMaxTaps] = {0.f, 0.f, 0.f, 0.f};
  for (int ci = 0; ci < c; ++ci) {
    const float gv = gp[ci * (int64_t)p];
    const float* s = src + ci * plane_len;
    float* ds = dsrc + ci * plane_len;
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) {
      if (!tp.ok[j]) continue;
      dw[j] = __fadd_rn(dw[j], __fmul_rn(gv, s[tp.off[j]]));
      const float contrib = __fmul_rn(tp.w[j], gv);
      if (contrib != 0.f) atomicAdd(ds + tp.off[j], contrib);
    }
  }
  float* dwp = d_w + ni * k * (int64_t)p + pi;
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) {
    if (j < k) dwp[j * (int64_t)p] = dw[j];
  }
}

int blocks_for(int n, int p) {
  return (int)(((int64_t)n * p + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tap count outside 1..4.  zidx may be null
// (plane 0 of d = 1: the corner pair).
int advchain_plane_sample_fwd(const float* img, const int* zidx,
                              const int* yxidx, const float* w, float* out,
                              int n, int c, int d, int hw, int p, int k,
                              int off0, int off1, int off2, int off3,
                              void* stream) {
  if (k < 1 || k > kMaxTaps) return (int)cudaErrorInvalidValue;
  const Offsets offs = {{off0, off1, off2, off3}};
  if ((int64_t)n * p > 0) {
    plane_sample_fwd_kernel<<<blocks_for(n, p), kThreads, 0,
                              (cudaStream_t)stream>>>(img, zidx, yxidx, w,
                                                      out, n, c, d, hw, p, k,
                                                      offs);
  }
  return (int)cudaGetLastError();
}

// d_img must be zeroed by the caller; d_w is fully written.
int advchain_plane_sample_bwd(const float* g, const float* img,
                              const int* zidx, const int* yxidx,
                              const float* w, float* d_img, float* d_w,
                              int n, int c, int d, int hw, int p, int k,
                              int off0, int off1, int off2, int off3,
                              void* stream) {
  if (k < 1 || k > kMaxTaps) return (int)cudaErrorInvalidValue;
  const Offsets offs = {{off0, off1, off2, off3}};
  if ((int64_t)n * p > 0) {
    plane_sample_bwd_kernel<<<blocks_for(n, p), kThreads, 0,
                              (cudaStream_t)stream>>>(g, img, zidx, yxidx, w,
                                                      d_img, d_w, n, c, d, hw,
                                                      p, k, offs);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
