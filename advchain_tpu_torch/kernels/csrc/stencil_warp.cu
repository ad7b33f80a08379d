// Near-identity 2D warp for Hopper (sm_90a): bilinear sampling with border
// padding and align_corners=True at a channel-first grid, forward and its
// analytic backward.
//
// Replaces the TPU kernels advchain_tpu/kernels/stencil.py::
// _stencil_fwd_2d_pallas and ::_stencil_bwd_2d_pallas (the custom VJP of
// ops/grid_sample.py::stencil_warp_2d).  The TPU versions edge-pad the image
// by R pixels, sum (2R+1)^2 static taps built from lane/sublane rolls of a
// VMEM-resident frame, and return the unfolded transposed stencil for the
// caller to fold.  None of that is needed here: each thread reads its four
// taps at CLAMPED rows and columns, which equals the edge-padded frame within
// R pixels and stays exact bilinear-with-border for any displacement, so
// the caller needs no radius bound and no fold.
//
// Contract (shared with the plain PyTorch versions in stencil_warp.py):
//   img (N, C, H, W) f32, flow (N, 2, H, W) f32 in [-1, 1] (channel 0 indexes
//   W, channel 1 indexes H), output on the flow's H x W grid.
//   xpix = (gx + 1) * 0.5 * (W - 1), x0 = floor(xpix), fx = xpix - x0 (the
//   unclipped coordinate); taps x0c = min(max(x0, 0), W-1) and
//   x1c = min(max(x0 + 1, 0), W-1); rows alike.
//   out = wy0 * (wx0 * v00 + wx1 * v01) + wy1 * (wx0 * v10 + wx1 * v11),
//   wx0 = 1 - fx, wx1 = fx, wy0 = 1 - fy, wy1 = fy.
// Backward: d_fx = wy0 * sum_c g (v01 - v00) + wy1 * sum_c g (v11 - v10),
//   d_fy = sum_c g inner1 - sum_c g inner0 (inner_r the row's x-lerp),
//   d_flow = (d_fx (W-1)/2, d_fy (H-1)/2) written per pixel, and
//   d_img += wy * wx * g at the four clamped taps (atomics; a collapsed tap
//   sums both weights, the exact transpose of edge padding).
// The arithmetic is written with __fmul_rn / __fadd_rn so that nvcc does not
// contract it into FMAs: a coordinate that rounds differently can flip
// floor() to another tap, which scaling and squaring then amplifies.
//
// Bound: both kernels move bytes, not operations (9 flops per (pixel,
// channel) forward, 24 backward).  At the headline's compositions (N=128,
// C=2, H=W=192) the forward must read img + flow and write out: 3 x 37.7 MB
// = 113 MB, 0.034 ms at 3.35 TB/s; the backward must read g + img + flow
// and write d_img + d_flow: 5 x 37.7 MB = 189 MB, 0.056 ms, and the zeroing
// of d_img before its atomics is one more 37.7 MB write.
// Design: one thread per output pixel (n, y, x), looping over C; a warp's
// threads read neighbouring flow values and, for near-identity grids,
// neighbouring image pixels, so the loads coalesce and the image stays in
// L2.  The flow gradient needs no atomics (one writer per pixel); the image
// gradient does, so its sum order is not fixed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Axis {
  int i0, i1;  // clamped taps
  float f;     // fraction of the unclipped coordinate
};

__device__ __forceinline__ Axis axis_taps(float g, int size) {
  // (g + 1) * 0.5 * (size - 1), each step rounded as the plain version does
  const float pix = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f),
                              (float)(size - 1));
  const float fl = floorf(pix);
  Axis a;
  a.f = __fsub_rn(pix, fl);
  // the taps no longer change below -1 or above size-1; clamping in float
  // first keeps the int conversion in range (fmaxf maps NaN to -1)
  const int i = (int)fminf(fmaxf(fl, -1.f), (float)(size - 1));
  a.i0 = max(i, 0);
  a.i1 = min(i + 1, size - 1);
  return a;
}

struct Taps {
  int64_t o00, o01, o10, o11;  // flat offsets of the four clamped taps
  float wx0, wx1, wy0, wy1;    // hat weights
};

__device__ __forceinline__ Taps pixel_taps(const float* fp, int64_t hw,
                                           int h, int w) {
  const Axis ax = axis_taps(fp[0], w);
  const Axis ay = axis_taps(fp[hw], h);
  Taps t;
  t.o00 = (int64_t)ay.i0 * w + ax.i0;
  t.o01 = (int64_t)ay.i0 * w + ax.i1;
  t.o10 = (int64_t)ay.i1 * w + ax.i0;
  t.o11 = (int64_t)ay.i1 * w + ax.i1;
  t.wx0 = __fsub_rn(1.f, ax.f);
  t.wx1 = ax.f;
  t.wy0 = __fsub_rn(1.f, ay.f);
  t.wy1 = ay.f;
  return t;
}

// the x-lerp of one row: wx0 * v0 + wx1 * v1
__device__ __forceinline__ float row_lerp(const Taps& t, float v0,
                                          float v1) {
  return __fadd_rn(__fmul_rn(t.wx0, v0), __fmul_rn(t.wx1, v1));
}

__global__ void __launch_bounds__(kThreads)
stencil_warp_fwd_kernel(const float* __restrict__ img,
                        const float* __restrict__ flow,
                        float* __restrict__ out, int n, int c, int h, int w) {
  const int64_t hw = (int64_t)h * w;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)n * hw) return;
  const int64_t ni = t / hw, pi = t - ni * hw;
  const Taps tp = pixel_taps(flow + ni * 2 * hw + pi, hw, h, w);
  const float* src = img + ni * c * hw;
  float* dst = out + ni * c * hw + pi;
  for (int ci = 0; ci < c; ++ci) {
    const float* s = src + ci * hw;
    const float in0 = row_lerp(tp, s[tp.o00], s[tp.o01]);
    const float in1 = row_lerp(tp, s[tp.o10], s[tp.o11]);
    dst[ci * hw] = __fadd_rn(__fmul_rn(tp.wy0, in0), __fmul_rn(tp.wy1, in1));
  }
}

__global__ void __launch_bounds__(kThreads)
stencil_warp_bwd_kernel(const float* __restrict__ g,
                        const float* __restrict__ img,
                        const float* __restrict__ flow,
                        float* __restrict__ d_img,
                        float* __restrict__ d_flow,
                        int n, int c, int h, int w) {
  const int64_t hw = (int64_t)h * w;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)n * hw) return;
  const int64_t ni = t / hw, pi = t - ni * hw;
  const Taps tp = pixel_taps(flow + ni * 2 * hw + pi, hw, h, w);
  const float w00 = __fmul_rn(tp.wy0, tp.wx0), w01 = __fmul_rn(tp.wy0, tp.wx1);
  const float w10 = __fmul_rn(tp.wy1, tp.wx0), w11 = __fmul_rn(tp.wy1, tp.wx1);
  const float* src = img + ni * c * hw;
  float* dsrc = d_img + ni * c * hw;
  const float* gp = g + ni * c * hw + pi;
  // per-row sums over channels: g * (v_r1 - v_r0) and g * inner_r
  float gx0 = 0.f, gx1 = 0.f, gy0 = 0.f, gy1 = 0.f;
  for (int ci = 0; ci < c; ++ci) {
    const float gv = gp[ci * hw];
    const float* s = src + ci * hw;
    const float v00 = s[tp.o00], v01 = s[tp.o01];
    const float v10 = s[tp.o10], v11 = s[tp.o11];
    gx0 = __fadd_rn(gx0, __fmul_rn(gv, __fsub_rn(v01, v00)));
    gx1 = __fadd_rn(gx1, __fmul_rn(gv, __fsub_rn(v11, v10)));
    gy0 = __fadd_rn(gy0, __fmul_rn(gv, row_lerp(tp, v00, v01)));
    gy1 = __fadd_rn(gy1, __fmul_rn(gv, row_lerp(tp, v10, v11)));
    float* ds = dsrc + ci * hw;
    const float c00 = __fmul_rn(w00, gv), c01 = __fmul_rn(w01, gv);
    const float c10 = __fmul_rn(w10, gv), c11 = __fmul_rn(w11, gv);
    if (c00 != 0.f) atomicAdd(ds + tp.o00, c00);
    if (c01 != 0.f) atomicAdd(ds + tp.o01, c01);
    if (c10 != 0.f) atomicAdd(ds + tp.o10, c10);
    if (c11 != 0.f) atomicAdd(ds + tp.o11, c11);
  }
  const float d_fx = __fadd_rn(__fmul_rn(tp.wy0, gx0), __fmul_rn(tp.wy1, gx1));
  const float d_fy = __fsub_rn(gy1, gy0);
  float* dfp = d_flow + ni * 2 * hw + pi;
  dfp[0] = __fmul_rn(d_fx, 0.5f * (float)(w - 1));
  dfp[hw] = __fmul_rn(d_fy, 0.5f * (float)(h - 1));
}

int blocks_for(int n, int h, int w) {
  return (int)(((int64_t)n * h * w + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int advchain_stencil_warp_fwd(const float* img, const float* flow, float* out,
                              int n, int c, int h, int w, void* stream) {
  if ((int64_t)n * h * w > 0) {
    stencil_warp_fwd_kernel<<<blocks_for(n, h, w), kThreads, 0,
                              (cudaStream_t)stream>>>(img, flow, out, n, c, h,
                                                      w);
  }
  return (int)cudaGetLastError();
}

// d_img must be zeroed by the caller; d_flow is fully written.
int advchain_stencil_warp_bwd(const float* g, const float* img,
                              const float* flow, float* d_img, float* d_flow,
                              int n, int c, int h, int w, void* stream) {
  if ((int64_t)n * h * w > 0) {
    stencil_warp_bwd_kernel<<<blocks_for(n, h, w), kThreads, 0,
                              (cudaStream_t)stream>>>(g, img, flow, d_img,
                                                      d_flow, n, c, h, w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
