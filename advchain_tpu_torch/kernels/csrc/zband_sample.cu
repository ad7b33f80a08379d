// Trilinear sampler for Hopper (sm_90a), two contracts on shared device code:
//
// 1. The grid-level pair (zband_grid_sample_fwd / _bwd): the image and the
//    normalised sampling grid go in; each thread unnormalises, pads and
//    floors its point's coordinates, folds the eight corner weights onto
//    the clipped base in registers, and gathers (forward) or scatters and
//    differentiates (backward).  The default 3D route.
// 2. The corner-level pair (zband_sample_fwd / _bwd): base indices and
//    folded weights built by the caller go in.  Kept as the kernel-level
//    counterpart of the TPU kernels and as the timed pre-fusion route.
//
// Replaces the TPU kernels advchain_tpu/kernels/gather_matmul.py::zband_gather
// (forward of _weighted_zband_sample) and ::zband_scatter (its backward,
// _wzs_bwd), together with the coordinate prep and corner fold of
// _grid_sample_3d_zband (which JAX differentiates by autodiff) and
// grid_sample_3d_pallas_nearest.  The TPU versions gather through a one-hot
// x matrix on the MXU over (z, y-band) blocks of a K=2 x-shifted stack held
// in VMEM or streamed from HBM, with bf16 value splits and channel groups;
// none of that is needed here: each thread reads its eight corners from
// device memory directly, in f32.
//
// Grid-level contract (shared with the plain versions in zband_sample.py):
//   img (N, C, D, H, W) f32, grid (N, P, 3) f32 normalised (x, y, z) in the
//   torch grid_sample convention; padding 0 zeros / 1 border / 2 reflection;
//   align_corners; nearest or trilinear.  out (N, C, P).  Per axis of size S
//   the coordinate is unnormalised, reflected (a select |.| and fmod) and
//   clipped per padding mode, then floored (x0, fraction f).  The base is
//   clip(x0, 0, S-1); the +1 tap collapses onto it when
//   clip(x0+1, 0, S-1) == clip(x0, 0, S-1); zeros padding masks raw taps
//   whose unclipped corner lies outside [0, S-1].  Raw weights
//   ((wz * wy) * wx) * mask are summed in (dz, dy, dx) order onto the corner
//   of the clipped base they fold to, and out = sum_k w_k v_k, k = 0..7 in
//   order: the arithmetic of kernels/_coords.py::corner_weights_3d followed
//   by the corner-level forward, so the forward equals its plain version
//   bit for bit.  Nearest: rint (half to even), the clip, one unit-weight
//   tap.
// Backward: d_img += w_k g at each valid tap; d_w_k = sum_c g v_k; d_grid by
//   the chain rule through the same steps: the fold passes d_w of a corner
//   to each raw tap folded onto it, d_f = d_w1 - d_w0 per axis, floor and
//   the collapse indicators pass nothing, clip passes half its gradient at
//   an exact bound (jnp.clip's subgradient; padding 3, edge, passes a
//   runtime edge_slope at the lower one), the reflection flips its sign
//   where it mirrors, and the unnormalisation scales by (S-1)/2 or S/2.
//   Nearest mode: d_grid is zero.
// The arithmetic is written with __fmul_rn / __fadd_rn so that nvcc does not
// contract it into FMAs: a coordinate that rounds differently can flip
// floor() to another tap.
//
// Bound: both pairs move bytes, not operations.  At the 3D episode's flow
// compositions (N=2, C=3, 12x192x192, P = D*H*W) the grid-level forward must
// read img + grid and write out: 10.6 + 10.6 + 10.6 MB = 31.9 MB, 0.0095 ms
// at 3.35 TB/s; the corner-level forward moved 60.2 MB (indices and folded
// weights are 44 bytes a point against the grid's 12), and its caller's fold
// took hundreds of PyTorch launches a sample.  The grid-level backward must
// read g, img and grid and write d_img and d_grid: 53.1 MB, 0.0158 ms.  The
// corner-level backward ran at 5x its bound on 8*C global atomics per
// point.
//
// Design of the grid-level pair:
// - Forward: one thread per output point.  Each block stages its points'
//   grid triples into shared memory with coalesced 16-byte loads (a 12-byte
//   stride per thread loads badly); each thread keeps its folded weights and
//   tap offsets in registers across the C channels, reads corners through
//   the read-only path and writes out coalesced; neighbouring points share
//   corners, so L1 and L2 serve the second reads.
// - Backward: one thread per point, the grid staged as in the forward;
//   each thread re-gathers its corners for d_w, adds w_k g into d_img with
//   global atomics (skipping zero contributions) and writes d_grid without
//   atomics, through shared memory so the store coalesces.  Exact for any
//   displacement, with no host read.
// - A backward that first accumulates each block's d_img in a shared-memory
//   box of its base corners was built and measured slower on an H100 at
//   every case of the 3D episode (PERF.md): an f32 atomicAdd to shared
//   memory compiles to a compare-and-swap loop (ATOMS.CAST.SPIN), the box
//   of a tile of consecutive points spans three planes, so it saves at
//   most ~2x of the global atomics, and its registers and shared memory
//   halve the resident warps.
// Atomics sum in no fixed order, so d_img (and, through the channel sum's
// order, d_grid) matches its plain version to f32 reassociation, not bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_coords.cuh"

namespace {

using namespace grid_coords;

constexpr int kThreads = 256;

// --------------------------------------------------- shared device code
struct Taps {
  int64_t base;  // flat offset of corner 0 within one channel
  int64_t hw;
  int w;
  unsigned ok;   // bit k: tap k lies inside the volume
  __device__ __forceinline__ int64_t off(int k) const {
    return base + ((k >> 2) & 1) * hw + ((k >> 1) & 1) * (int64_t)w + (k & 1);
  }
};

__device__ __forceinline__ Taps corner_taps(int z, int y, int x, int d, int h,
                                            int w) {
  Taps t;
  const bool zs[2] = {z >= 0 && z < d, z + 1 >= 0 && z + 1 < d};
  const bool ys[2] = {y >= 0 && y < h, y + 1 >= 0 && y + 1 < h};
  const bool xs[2] = {x >= 0 && x < w, x + 1 >= 0 && x + 1 < w};
  t.hw = (int64_t)h * w;
  t.w = w;
  t.base = ((int64_t)z * h + y) * w + x;
  t.ok = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (zs[k >> 2] && ys[(k >> 1) & 1] && xs[k & 1]) t.ok |= 1u << k;
  }
  return t;
}

// the eight corner values of one channel, zero where a tap is outside
__device__ __forceinline__ void read_corners(const float* __restrict__ s,
                                             const Taps& tap, float v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (tap.ok >> k) & 1 ? __ldg(s + tap.off(k))
                                                       : 0.f;
}

// k = 0..7 in order, each product rounded: the plain version's sum
__device__ __forceinline__ float weighted_sum(const float wk[8],
                                              const float v[8]) {
  float acc = __fmul_rn(wk[0], v[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(wk[k], v[k]));
  return acc;
}

// One point: its three axes, folded weights and taps.
struct Point {
  Axis ax, ay, az;
  float raw[8];  // raw weights in (dz, dy, dx) order, zeros-masked
  float wf[8];   // folded onto the clipped base's corners
  int mask;      // corner bits that do not collapse: raw tap j -> j & mask
  Taps tap;
};

__device__ __forceinline__ void point_prep(Point& pt, const float* gxyz,
                                           int d, int h, int w, bool align,
                                           int padding, bool nearest,
                                           float edge_slope = 1.f) {
  pt.ax = axis_prep(gxyz[0], w, align, padding, nearest, edge_slope);
  pt.ay = axis_prep(gxyz[1], h, align, padding, nearest, edge_slope);
  pt.az = axis_prep(gxyz[2], d, align, padding, nearest, edge_slope);
  pt.tap = corner_taps(pt.az.i0, pt.ay.i0, pt.ax.i0, d, h, w);
  pt.mask = (pt.az.m << 2) | (pt.ay.m << 1) | pt.ax.m;
  if (nearest) {
    const float w0 = pt.ax.in[0] && pt.ay.in[0] && pt.az.in[0] ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) pt.raw[k] = pt.wf[k] = k ? 0.f : w0;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int dz = j >> 2, dy = (j >> 1) & 1, dx = j & 1;
    const bool in = pt.az.in[dz] && pt.ay.in[dy] && pt.ax.in[dx];
    pt.raw[j] = __fmul_rn(__fmul_rn(__fmul_rn(pt.az.w[dz], pt.ay.w[dy]),
                                    pt.ax.w[dx]), in ? 1.f : 0.f);
  }
  if (pt.mask == 7) {  // no collapsed tap: the fold is the identity
#pragma unroll
    for (int k = 0; k < 8; ++k) pt.wf[k] = pt.raw[k];
    return;
  }
  // raw tap j folds onto corner j & mask; each corner sums its raw taps in
  // raw order (static indices keep the arrays in registers)
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((j & pt.mask) == k) acc = __fadd_rn(acc, pt.raw[j]);
    }
    pt.wf[k] = acc;
  }
}

// d_grid of one point from d_w (the folded weights' gradient), written to
// out[0..2] in (x, y, z) order.
__device__ __forceinline__ void grid_grad(const Point& pt, const float dw[8],
                                          float out[3]) {
  // the fold: each raw tap receives its corner's gradient; zeros-masked
  // raw taps receive nothing
  float dr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int dz = j >> 2, dy = (j >> 1) & 1, dx = j & 1;
    float v = dw[j];
    if (pt.mask != 7) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if ((j & pt.mask) == k) v = dw[k];
      }
    }
    dr[j] = pt.az.in[dz] && pt.ay.in[dy] && pt.ax.in[dx] ? v : 0.f;
  }
  // raw = ((wz * wy) * wx): d_wx from wz * wy, d_wy and d_wz from dr * wx
  float dwx[2] = {0.f, 0.f}, dwy[2] = {0.f, 0.f}, dwz[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int dz = j >> 2, dy = (j >> 1) & 1, dx = j & 1;
    const float wzy = __fmul_rn(pt.az.w[dz], pt.ay.w[dy]);
    dwx[dx] = __fadd_rn(dwx[dx], __fmul_rn(dr[j], wzy));
    const float drx = __fmul_rn(dr[j], pt.ax.w[dx]);
    dwy[dy] = __fadd_rn(dwy[dy], __fmul_rn(drx, pt.az.w[dz]));
    dwz[dz] = __fadd_rn(dwz[dz], __fmul_rn(drx, pt.ay.w[dy]));
  }
  // slope is a power of two (or 0): only the product with scale rounds
  out[0] = __fmul_rn(__fmul_rn(__fsub_rn(dwx[1], dwx[0]) * pt.ax.slope,
                               pt.ax.scale), 0.5f);
  out[1] = __fmul_rn(__fmul_rn(__fsub_rn(dwy[1], dwy[0]) * pt.ay.slope,
                               pt.ay.scale), 0.5f);
  out[2] = __fmul_rn(__fmul_rn(__fsub_rn(dwz[1], dwz[0]) * pt.az.slope,
                               pt.az.scale), 0.5f);
}

// Copy `count` floats from global to shared memory, 16 bytes a thread where
// the source is aligned.  `dst` is 16-byte aligned.
__device__ __forceinline__ void stage_in(float* dst,
                                         const float* __restrict__ src,
                                         int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = __ldg(s4 + i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) {
    dst[i] = __ldg(src + i);
  }
}

// The reverse of stage_in.
__device__ __forceinline__ void stage_out(float* __restrict__ dst,
                                          const float* src, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// ---------------------------------------------- grid-level kernels
__global__ void __launch_bounds__(kThreads)
zband_grid_fwd_kernel(const float* __restrict__ img,
                      const float* __restrict__ grid,
                      float* __restrict__ out, int n, int c, int d, int h,
                      int w, int p, int padding, bool align, bool nearest) {
  __shared__ __align__(16) float sgrid[kThreads * 3];
  const int64_t np = (int64_t)n * p;
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int count = (int)min((int64_t)kThreads, np - first);
  stage_in(sgrid, grid + first * 3, count * 3);
  __syncthreads();
  if (threadIdx.x >= count) return;
  const int64_t t = first + threadIdx.x;
  const int64_t ni = t / p, pi = t - ni * p;
  Point pt;
  point_prep(pt, sgrid + 3 * threadIdx.x, d, h, w, align, padding, nearest);
  const int64_t dhw = (int64_t)d * h * w;
  const float* src = img + ni * c * dhw;
  float* dst = out + ni * c * p + pi;
  for (int ci = 0; ci < c; ++ci) {
    const float* s = src + ci * dhw;
    if (nearest) {  // one unit-weight tap; the others carry weight 0
      dst[ci * (int64_t)p] = __fmul_rn(pt.wf[0], __ldg(s + pt.tap.base));
    } else {
      float v[8];
      read_corners(s, pt.tap, v);
      dst[ci * (int64_t)p] = weighted_sum(pt.wf, v);
    }
  }
}

// d_img must be zeroed by the caller.  One thread a point, blocks of
// kThreads points of one batch element.
__global__ void __launch_bounds__(kThreads)
zband_grid_bwd_kernel(const float* __restrict__ g,
                      const float* __restrict__ img,
                      const float* __restrict__ grid,
                      float* __restrict__ d_img, float* __restrict__ d_grid,
                      const float* __restrict__ edge_slope, int n, int c,
                      int d, int h, int w, int p, int padding, bool align,
                      bool nearest) {
  __shared__ __align__(16) float sgrid[kThreads * 3];
  const int tiles = (p + kThreads - 1) / kThreads;
  const int ni = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - ni * tiles) * kThreads;
  const int count = min(kThreads, p - p0);
  stage_in(sgrid, grid + ((int64_t)ni * p + p0) * 3, count * 3);
  __syncthreads();

  const int q = threadIdx.x;
  if (q < count) {
    const int64_t dhw = (int64_t)d * h * w;
    const float* src = img + (int64_t)ni * c * dhw;
    float* dsrc = d_img + (int64_t)ni * c * dhw;
    Point pt;
    point_prep(pt, sgrid + 3 * q, d, h, w, align, padding, nearest,
               edge_slope ? __ldg(edge_slope) : 1.f);
    const float* gp = g + ((int64_t)ni * c) * p + p0 + q;
    float dw[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int taps = nearest ? 1 : 8;
    for (int ci = 0; ci < c; ++ci) {
      const float gv = __ldg(gp + ci * (int64_t)p);
      const float* s = src + ci * dhw;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= taps || !((pt.tap.ok >> k) & 1)) continue;
        if (!nearest) {
          dw[k] = __fadd_rn(dw[k], __fmul_rn(gv, __ldg(s + pt.tap.off(k))));
        }
        const float contrib = __fmul_rn(pt.wf[k], gv);
        if (contrib != 0.f) {
          atomicAdd(dsrc + ci * dhw + pt.tap.off(k), contrib);
        }
      }
    }
    float dg[3] = {0.f, 0.f, 0.f};
    if (!nearest) grid_grad(pt, dw, dg);
    // this thread alone reads point q's staged grid: overwrite it in place
#pragma unroll
    for (int k = 0; k < 3; ++k) sgrid[3 * q + k] = dg[k];
  }
  __syncthreads();
  stage_out(d_grid + ((int64_t)ni * p + p0) * 3, sgrid, count * 3);
}

// -------------------------------------------- corner-level kernels
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
    float v[8];
    read_corners(src + ci * dhw, tap, v);
    dst[ci * (int64_t)p] = weighted_sum(wk, v);
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
      if (!((tap.ok >> k) & 1)) continue;
      dw[k] += gv * s[tap.off(k)];
      const float contrib = wk[k] * gv;
      if (contrib != 0.f) atomicAdd(ds + tap.off(k), contrib);
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

// padding: 0 zeros, 1 border, 2 reflection; align, nearest: 0 or 1.
int advchain_zband_grid_sample_fwd(const float* img, const float* grid,
                                   float* out, int n, int c, int d, int h,
                                   int wd, int p, int padding, int align,
                                   int nearest, void* stream) {
  if ((int64_t)n * p > 0) {
    zband_grid_fwd_kernel<<<blocks_for(n, p), kThreads, 0,
                            (cudaStream_t)stream>>>(img, grid, out, n, c, d,
                                                    h, wd, p, padding,
                                                    align != 0, nearest != 0);
  }
  return (int)cudaGetLastError();
}

// d_img must be zeroed by the caller; d_grid is fully written.  padding 3
// (edge) is border padding whose grid slope at an exact lower bound is
// *edge_slope (one float on the device; null for 1).
int advchain_zband_grid_sample_bwd(const float* g, const float* img,
                                   const float* grid, float* d_img,
                                   float* d_grid, const float* edge_slope,
                                   int n, int c, int d, int h, int wd, int p,
                                   int padding, int align, int nearest,
                                   void* stream) {
  if ((int64_t)n * p > 0) {
    const int blocks = n * ((p + kThreads - 1) / kThreads);
    zband_grid_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g, img, grid, d_img, d_grid, edge_slope, n, c, d, h, wd, p, padding,
        align != 0, nearest != 0);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
