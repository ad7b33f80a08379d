// Bilinear sampler for Hopper (sm_90a): the grid-level pair
// (band_grid_sample_fwd / _bwd).  The image and the normalised sampling grid
// go in; each thread unnormalises, pads and floors its point's coordinates
// (grid_coords.cuh, shared with the 3D sampler), folds the four corner
// weights onto the clipped base in registers, and gathers (forward) or
// scatters and differentiates (backward).  The default 2D route.
//
// Replaces the TPU kernels advchain_tpu/kernels/gather_matmul.py::band_gather
// (forward of _weighted_band_sample) and ::band_scatter (its backward,
// _wbs_bwd), together with the coordinate prep and corner fold of
// grid_sample_2d_pallas (which JAX differentiates by autodiff) and
// grid_sample_2d_pallas_nearest.  The TPU versions gather through a one-hot
// matrix product on the MXU, split f32 into bf16 pieces and walk row bands
// held in VMEM; none of that is needed here: each thread reads its four
// corners from device memory directly, in f32.
//
// Grid-level contract (shared with the plain versions in band_sample.py):
//   img (N, C, H, W) f32, grid (N, P, 2) f32 normalised (x, y) in the torch
//   grid_sample convention; padding 0 zeros / 1 border / 2 reflection;
//   align_corners; nearest or bilinear.  out (N, C, P).  Per axis the
//   coordinate is prepared as grid_coords.cuh says; raw weights
//   (wx * wy) * mask are summed in (dy, dx) order onto the corner of the
//   clipped base they fold to, and out = sum_k w_k v_k, k = 0..3 in order:
//   the arithmetic of kernels/_coords.py::corner_weights followed by the
//   corner sum of band_sample.py::band_sample_fwd_plain (the body of the
//   plain version), so the forward equals its plain version bit for bit.
//   Nearest: rint (half to even), the clip, one unit-weight tap.
// Backward: d_img += w_k g at each valid tap; d_w_k = sum_c g v_k; d_grid by
//   the chain rule through the same steps: the fold passes d_w of a corner
//   to each raw tap folded onto it, d_f = d_w1 - d_w0 per axis, floor and
//   the collapse indicators pass nothing, clip passes half its gradient at
//   an exact bound (jnp.clip's subgradient), the reflection flips its sign
//   where it mirrors, and the unnormalisation scales by (S-1)/2 or S/2.
//   Nearest mode: d_grid is zero.
//
// Bound: the pair moves bytes, not operations.  At its most frequent call
// (the image and mask warps: N=128, C=1, H=W=192, P=H*W) the forward must
// read img + grid and write out: 18.9 + 37.7 + 18.9 MB = 75.5 MB, 0.0225 ms
// at 3.35 TB/s; base indices and folded weights built by a caller would be
// 24 bytes a point against the grid's 8, and their fold about a hundred
// PyTorch launches a sample.  The backward must read g, img and grid and
// write d_img and d_grid: 132 MB, 0.0395 ms; zeroing d_img is one more
// write.
//
// Design: one thread per output point, blocks of kThreads points of one
// batch element (blockIdx.y), so no division.  Each
// thread loads its (x, y) pair with one 8-byte float2 load, coalesced
// across the warp (no shared-memory staging, which the 3D pair needs for
// its 12-byte triples), keeps its folded weights and tap offsets in
// registers across the C channels and reads corners through the read-only
// path; neighbouring points share corners, so L1 and L2 serve the second
// reads.  The backward re-gathers its corners for d_w, adds w_k g into
// d_img with global atomics, skipping zero contributions and merging a
// lane's +1-column taps into the next lane's base-column taps where they
// coincide (warp shuffles; on an H100, 14-17% faster on the image warps'
// rotation and no slower on near-identity warps, PERF.md; a shared-memory
// box lost to plain atomics in 3D, since f32 shared atomics are a
// compare-and-swap loop on this card), and writes d_grid as one float2.
// Exact for any displacement, with no host read.  The arithmetic is
// written with __fmul_rn / __fadd_rn so that nvcc does not contract it into
// FMAs: a coordinate that rounds differently can flip floor() to another
// tap.  Atomics sum in no fixed order, so d_img (and, through the channel
// sum's order, d_grid) matches its plain version to f32 reassociation, not
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_coords.cuh"

namespace {

using namespace grid_coords;

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

// One point: its two axes, folded weights and taps.
struct Point {
  Axis ax, ay;
  float wf[4];  // folded onto the clipped base's corners (0,0) .. (1,1)
  int mask;     // corner bits that do not collapse: raw tap j -> j & mask
  Taps tap;
};

__device__ __forceinline__ void point_prep(Point& pt, float gx, float gy,
                                           int h, int w, bool align,
                                           int padding, bool nearest) {
  pt.ax = axis_prep(gx, w, align, padding, nearest);
  pt.ay = axis_prep(gy, h, align, padding, nearest);
  pt.tap = corner_taps(pt.ay.i0, pt.ax.i0, h, w);
  pt.mask = (pt.ay.m << 1) | pt.ax.m;
  if (nearest) {
    pt.wf[0] = pt.ax.in[0] && pt.ay.in[0] ? 1.f : 0.f;
    pt.wf[1] = pt.wf[2] = pt.wf[3] = 0.f;
    return;
  }
  // raw weights in (dy, dx) order, ((1 - fx) * (1 - fy)) * mask and so on
  float raw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int dy = j >> 1, dx = j & 1;
    const bool in = pt.ay.in[dy] && pt.ax.in[dx];
    raw[j] = __fmul_rn(__fmul_rn(pt.ax.w[dx], pt.ay.w[dy]), in ? 1.f : 0.f);
  }
  if (pt.mask == 3) {  // no collapsed tap: the fold is the identity
#pragma unroll
    for (int k = 0; k < 4; ++k) pt.wf[k] = raw[k];
    return;
  }
  // raw tap j folds onto corner j & mask; each corner sums its raw taps in
  // raw order, as _fold_2d's sums do (static indices keep the arrays in
  // registers)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((j & pt.mask) == k) acc = __fadd_rn(acc, raw[j]);
    }
    pt.wf[k] = acc;
  }
}

// d_grid of one point from d_w (the folded weights' gradient), (x, y).
__device__ __forceinline__ float2 grid_grad(const Point& pt,
                                            const float dw[4]) {
  // the fold: each raw tap receives its corner's gradient; zeros-masked
  // raw taps receive nothing.  raw = (wx * wy) * mask: d_wx from wy, d_wy
  // from wx
  float dwx[2] = {0.f, 0.f}, dwy[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int dy = j >> 1, dx = j & 1;
    float v = dw[j];
    if (pt.mask != 3) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((j & pt.mask) == k) v = dw[k];
      }
    }
    const float dr = pt.ay.in[dy] && pt.ax.in[dx] ? v : 0.f;
    dwx[dx] = __fadd_rn(dwx[dx], __fmul_rn(dr, pt.ay.w[dy]));
    dwy[dy] = __fadd_rn(dwy[dy], __fmul_rn(dr, pt.ax.w[dx]));
  }
  // slope is a power of two (or 0): only the product with scale rounds
  return make_float2(
      __fmul_rn(__fmul_rn(__fsub_rn(dwx[1], dwx[0]) * pt.ax.slope,
                          pt.ax.scale), 0.5f),
      __fmul_rn(__fmul_rn(__fsub_rn(dwy[1], dwy[0]) * pt.ay.slope,
                          pt.ay.scale), 0.5f));
}

// Point t's (x, y): one 8-byte load where the array is 8-byte aligned.
__device__ __forceinline__ float2 load_xy(const float* __restrict__ grid,
                                          int64_t t) {
  if ((reinterpret_cast<uintptr_t>(grid) & 7) == 0) {
    return __ldg(reinterpret_cast<const float2*>(grid) + t);
  }
  return make_float2(__ldg(grid + 2 * t), __ldg(grid + 2 * t + 1));
}

__device__ __forceinline__ void store_xy(float* __restrict__ out, int64_t t,
                                         float2 v) {
  if ((reinterpret_cast<uintptr_t>(out) & 7) == 0) {
    reinterpret_cast<float2*>(out)[t] = v;
  } else {
    out[2 * t] = v.x;
    out[2 * t + 1] = v.y;
  }
}

__global__ void __launch_bounds__(kThreads)
band_grid_fwd_kernel(const float* __restrict__ img,
                     const float* __restrict__ grid,
                     float* __restrict__ out, int c, int h, int w, int p,
                     int padding, bool align, bool nearest) {
  const int ni = blockIdx.y;
  const int pi = blockIdx.x * kThreads + threadIdx.x;
  if (pi >= p) return;
  const int64_t t = (int64_t)ni * p + pi;
  const float2 xy = load_xy(grid, t);
  Point pt;
  point_prep(pt, xy.x, xy.y, h, w, align, padding, nearest);
  const int64_t hw = (int64_t)h * w;
  const float* src = img + (int64_t)ni * c * hw;
  float* dst = out + (int64_t)ni * c * p + pi;
  for (int ci = 0; ci < c; ++ci) {
    const float* s = src + ci * hw;
    if (nearest) {  // one unit-weight tap; the others carry weight 0
      dst[ci * (int64_t)p] = __fmul_rn(pt.wf[0], __ldg(s + pt.tap.off[0]));
      continue;
    }
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = pt.tap.ok[k] ? __ldg(s + pt.tap.off[k])
                                                    : 0.f;
    // k = 0..3 in order, each product rounded: the plain version's sum
    float acc = __fmul_rn(pt.wf[0], v[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) acc = __fadd_rn(acc, __fmul_rn(pt.wf[k], v[k]));
    dst[ci * (int64_t)p] = acc;
  }
}

// d_img must be zeroed by the caller; d_grid is fully written.  Every
// thread of a warp runs to the end (the shuffles need all 32 lanes); one
// past the last point adds nothing and writes nothing.
__global__ void __launch_bounds__(kThreads)
band_grid_bwd_kernel(const float* __restrict__ g,
                     const float* __restrict__ img,
                     const float* __restrict__ grid,
                     float* __restrict__ d_img, float* __restrict__ d_grid,
                     int c, int h, int w, int p, int padding, bool align,
                     bool nearest) {
  const int ni = blockIdx.y;
  const int pi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = pi < p;
  const int64_t t = (int64_t)ni * p + (active ? pi : 0);
  const float2 xy = load_xy(grid, t);
  Point pt;
  point_prep(pt, xy.x, xy.y, h, w, align, padding, nearest);
  const int64_t hw = (int64_t)h * w;
  const float* src = img + (int64_t)ni * c * hw;
  float* dsrc = d_img + (int64_t)ni * c * hw;
  const float* gp = g + (int64_t)ni * c * p + (active ? pi : 0);
  float dw[4] = {0.f, 0.f, 0.f, 0.f};
  const int taps = nearest ? 1 : 4;
  const int lane = threadIdx.x & 31;
  for (int ci = 0; ci < c; ++ci) {
    const float gv = active ? __ldg(gp + ci * (int64_t)p) : 0.f;
    const float* s = src + ci * hw;
    float* ds = dsrc + ci * hw;
    float contrib[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool use = k < taps && pt.tap.ok[k];
      if (use && !nearest) {
        dw[k] = __fadd_rn(dw[k], __fmul_rn(gv, __ldg(s + pt.tap.off[k])));
      }
      contrib[k] = use ? __fmul_rn(pt.wf[k], gv) : 0.f;
    }
    if (!nearest) {
      // warp aggregation: lane i hands its +1-column taps (0,1) and (1,1)
      // to lane i + 1 where they land on that lane's (0,0) and (1,0), so
      // one atomic carries both (along a smooth warp's rows, half the
      // time)
#pragma unroll
      for (int a = 1; a < 4; a += 2) {
        const int b = a - 1;
        const int64_t up_off = __shfl_up_sync(0xffffffffu, pt.tap.off[a], 1);
        const float up = __shfl_up_sync(0xffffffffu, contrib[a], 1);
        const bool take = lane > 0 && up != 0.f && pt.tap.ok[b]
                          && up_off == pt.tap.off[b];
        if (take) contrib[b] += up;
        const bool given = __shfl_down_sync(0xffffffffu, take, 1);
        if (given && lane < 31) contrib[a] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (contrib[k] != 0.f) atomicAdd(ds + pt.tap.off[k], contrib[k]);
    }
  }
  if (active) {
    store_xy(d_grid, t, nearest ? make_float2(0.f, 0.f) : grid_grad(pt, dw));
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
// padding: 0 zeros, 1 border, 2 reflection; align, nearest: 0 or 1.
int advchain_band_grid_sample_fwd(const float* img, const float* grid,
                                  float* out, int n, int c, int h, int wd,
                                  int p, int padding, int align, int nearest,
                                  void* stream) {
  if ((int64_t)n * p > 0) {
    const dim3 blocks((p + kThreads - 1) / kThreads, n);
    band_grid_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        img, grid, out, c, h, wd, p, padding, align != 0, nearest != 0);
  }
  return (int)cudaGetLastError();
}

// d_img must be zeroed by the caller; d_grid is fully written.
int advchain_band_grid_sample_bwd(const float* g, const float* img,
                                  const float* grid, float* d_img,
                                  float* d_grid, int n, int c, int h, int wd,
                                  int p, int padding, int align, int nearest,
                                  void* stream) {
  if ((int64_t)n * p > 0) {
    const dim3 blocks((p + kThreads - 1) / kThreads, n);
    band_grid_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g, img, grid, d_img, d_grid, c, h, wd, p, padding, align != 0,
        nearest != 0);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
