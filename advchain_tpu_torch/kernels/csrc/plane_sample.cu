// Plane samplers for Hopper (sm_90a), two contracts:
//
// 1. The grid-level plane pair (plane_grid_sample_fwd / _bwd): the image and
//    the normalised sampling grid go in; each thread unnormalises, pads and
//    floors its point's coordinates, builds the packed formulation's two
//    clipped z planes and their folded in-plane weights in registers, and
//    gathers (forward) or scatters and differentiates (backward), both z
//    taps in one launch.  The 3D trilinear route under ADVCHAIN_ZBAND=0.
// 2. The flat-index corner and plane pair (corner_sample_* / plane_sample_*):
//    the forward gather with its weighted sum and the backward scatter with
//    the weight gradient, for K <= 4 static non-negative tap offsets, on
//    indices and weights built by the caller.  The 2D route under
//    ADVCHAIN_BAND_KERNEL=0, and the kernel-level counterpart of the TPU
//    plane kernels.
//
// Replaces the TPU kernels advchain_tpu/kernels/gather_matmul.py::
// corner_gather (with _corner_gather_streamed), ::corner_scatter (with
// _corner_scatter_resident and _corner_scatter_chunk_major), ::plane_gather
// and ::plane_scatter (with _plane_scatter_streamed): the forward and the
// backward of _weighted_corner_sample (the 2D sampler with
// ADVCHAIN_BAND_KERNEL=0) and of _weighted_plane_sample, with the
// coordinate prep and in-plane fold of _grid_sample_3d_pallas_packed (the 3D
// sampler with ADVCHAIN_ZBAND=0, which JAX differentiates by autodiff).  The
// corner pair is the plane pair with one plane, so one flat kernel pair
// serves both: a null zidx means plane 0.  The TPU versions stack K
// pre-shifted copies of the image, gather through one-hot MXU matmuls with
// f32 split into bf16 pieces, and come in VMEM-resident, HBM-streamed and
// chunk-major variants; none of that is needed here: each thread reads its
// taps from device memory directly, in f32.
//
// Grid-level contract (shared with the plain versions in plane_sample.py):
//   img (N, C, D, H, W) f32, grid (N, P, 3) f32 normalised (x, y, z) in the
//   torch grid_sample convention; padding 0 zeros / 1 border / 2 reflection
//   / 3 edge (border whose slope at an exact lower bound is *edge_slope);
//   align_corners.  out (N, C, P).  Per axis grid_coords.cuh's axis_prep
//   (unnormalise, reflect, clip, floor).  The in-plane base is
//   yx = y0c * W + x0c (int32) with taps (0, 1, W, W+1); the z taps are the
//   planes clip(z0, 0, D-1) and clip(z0 + 1, 0, D-1), NOT folded onto each
//   other.  Per z tap dz the raw weights ((wx * wy) * wz) * mask (zeros
//   padding masks raw taps whose unclipped corner lies outside the volume)
//   fold onto the in-plane taps of the clipped base in fold_2d's order
//   (kernels/_coords.py), and
//     out = part(dz=0) + part(dz=1),  part = sum_k cw_k v_k, k = 0..3,
//   where a tap at or past the plane's flat end (HW) reads zero: the
//   arithmetic of _coords.plane_weights followed by two flat plane
//   forwards and their sum, so the forward equals its plain version bit for
//   bit.
// Backward: d_img += cw_k g at each valid tap; d_cw_k = sum_c g v_k per z
//   tap; d_grid by the chain rule through the same steps: the in-plane fold
//   passes d_cw of a tap to each raw tap folded onto it (dxf / dyf are
//   constants), zeros-masked raw taps receive nothing, d_f = d_w1 - d_w0 per
//   axis through raw = ((wx * wy) * wz), floor passes nothing, clip passes
//   half its gradient at an exact bound (edge: *edge_slope at the lower
//   one), the reflection flips its sign where it mirrors, and the
//   unnormalisation scales by (S-1)/2 or S/2.
//
// Flat contract (shared with the plain versions in plane_sample.py):
//   img (N, C, D, HW) f32 (D = 1 for the corner pair), zidx (N, P) i32 or
//   null, yxidx (N, P) i32, w (N, K, P) f32, offsets off[0..K-1] >= 0.
//   out[n,c,p] = sum_k w[n,k,p] * img[n, c, z, yx + off[k]]
//   A tap reads zero and receives no gradient when yx + off[k] falls outside
//   [0, HW) or z outside [0, D): the zero padding past each plane's flat end
//   that the TPU kernels read (a shift never bleeds into the next plane).
//   Inside [0, HW) the +1 tap of a row's last pixel is the next row's first
//   pixel; the samplers give that tap weight 0.
//   The forward sums k = 0..K-1 in order with each product rounded.
// All arithmetic is written with __fmul_rn / __fadd_rn, so nvcc does not
// contract it into FMAs: the forwards equal their plain versions bit for bit.
//
// Bound: all four kernels move bytes, not operations.  The grid-level pair
// at the 3D episode's flow compositions (N=2, C=3, 12x192x192, P = D*H*W):
// the forward must read img + grid and write out, 10.6 + 10.6 + 10.6 MB =
// 31.9 MB, 0.0095 ms at 3.35 TB/s; the backward reads g, img and grid and
// writes d_img and d_grid, 53.1 MB, 0.0158 ms (the z-band grid pair's
// bytes).  The flat pair it replaces on that route moved 60 MB a sample
// forward in two launches (indices and folded weights are 44 bytes a point
// against the grid's 12), behind a fold of several dozen PyTorch launches;
// its backward zeroed and scattered two (N, C, D, HW) d_img and summed them.
// At the 2D episode's image warps (N=128, C=1, 192x192, K=4) the flat
// forward must move img + idx + w + out = 132 MB, 0.039 ms.
//
// Design of the grid-level pair: one thread per point.  A block stages its
// points' grid triples into shared memory with 16-byte loads (a 12-byte
// stride per thread loads badly); each thread keeps its two planes' offsets,
// eight folded weights and tap validity in registers across the C channels,
// reads its taps through the read-only path (neighbouring points share
// taps, so L1 and L2 serve the second reads) and writes out coalesced.  The
// backward re-gathers the taps for d_cw, adds cw_k g into one d_img with
// global atomics (skipping zero contributions; the caller's one zero fill)
// and writes d_grid without atomics, through shared memory so the store
// coalesces.  The lever it was built to try, Hopper's vector float atomics,
// does not pay here: the taps (yx, yx+1) and (yx+W, yx+W+1) are adjacent
// floats, and compute capability 9.x adds float4 atomicAdd in global memory,
// so a pair whose first index is not 3 mod 4 can go out as one 16-byte
// float4 add with two zero lanes (4 atomics instead of 8 per point and
// channel for three points in four), or a pair at an even index as one
// float2; on an H100 both are slower than scalar adds at chip_smoke.py's
// two 3D grids (scripts/plane_atomics_bench.py, PERF.md), likely because
// neighbouring points' pairs share blocks, so one warp's vector adds
// serialise on a few addresses where its scalar adds spread over many.
// Atomics sum in no fixed order, so d_img (and, through the channel sum's
// order, d_grid) matches its plain version to f32 reassociation, not bit
// for bit.
//
// Design of the flat pair: one thread per output point (n, p); its K
// weights and offsets are loaded once and reused across the C channels.
// The backward re-gathers the taps instead of reading a saved (N, K, C, P)
// tensor; d_w needs no atomics (one writer per point), d_img is zeroed by
// the caller and filled by atomicAdd, skipping zero contributions, so its
// sum order is not fixed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_coords.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 4;

// ---------------------------------------------- grid-level plane pair
using grid_coords::Axis;
using grid_coords::axis_prep;
using grid_coords::stage_in;
using grid_coords::stage_out;

// One point of the packed formulation: its axes, the two z taps' planes and
// folded in-plane weights.
struct PlanePoint {
  Axis ax, ay, az;
  int64_t tap0[2];  // flat offset of tap 0 (yx) of plane dz within a channel
  float cw[2][4];   // folded weights of plane dz on offsets (0, 1, W, W+1)
  unsigned ok;      // bit k: yx + off[k] < HW (both planes)
};

__device__ __forceinline__ void plane_point_prep(PlanePoint& pt,
                                                 const float* gxyz, int d,
                                                 int h, int w, bool align,
                                                 int padding,
                                                 float edge_slope = 1.f) {
  pt.ax = axis_prep(gxyz[0], w, align, padding, false, edge_slope);
  pt.ay = axis_prep(gxyz[1], h, align, padding, false, edge_slope);
  pt.az = axis_prep(gxyz[2], d, align, padding, false, edge_slope);
  const int hw = h * w;  // the wrapper keeps the volume below 2^31
  const int yx = pt.ay.i0 * w + pt.ax.i0;
  pt.ok = 1u | (yx + 1 < hw ? 2u : 0u) | (yx + w < hw ? 4u : 0u)
          | (yx + w + 1 < hw ? 8u : 0u);
  // clip(z0 + 1, 0, D-1) is the clipped base plus its collapse indicator
  pt.tap0[0] = (int64_t)pt.az.i0 * hw + yx;
  pt.tap0[1] = (int64_t)(pt.az.i0 + pt.az.m) * hw + yx;
  const float dxf = (float)pt.ax.m, dyf = (float)pt.ay.m;
  const float ndx = __fsub_rn(1.f, dxf), ndy = __fsub_rn(1.f, dyf);
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    // raw weights ((wx * wy) * wz) * mask in (dy, dx) order: w00 w01 w10 w11
    float raw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dy = k >> 1, dx = k & 1;
      const bool in = pt.ax.in[dx] && pt.ay.in[dy] && pt.az.in[dz];
      raw[k] = __fmul_rn(__fmul_rn(__fmul_rn(pt.ax.w[dx], pt.ay.w[dy]),
                                   pt.az.w[dz]), in ? 1.f : 0.f);
    }
    // fold_2d, term for term
    pt.cw[dz][0] = __fadd_rn(
        __fadd_rn(__fadd_rn(raw[0], __fmul_rn(raw[1], ndx)),
                  __fmul_rn(raw[2], ndy)),
        __fmul_rn(__fmul_rn(raw[3], ndx), ndy));
    pt.cw[dz][1] = __fadd_rn(__fmul_rn(raw[1], dxf),
                             __fmul_rn(__fmul_rn(raw[3], dxf), ndy));
    pt.cw[dz][2] = __fadd_rn(__fmul_rn(raw[2], dyf),
                             __fmul_rn(__fmul_rn(raw[3], ndx), dyf));
    pt.cw[dz][3] = __fmul_rn(__fmul_rn(raw[3], dxf), dyf);
  }
}

// d_grid of one point from d_cw (the folded weights' gradient per z tap),
// written to out[0..2] in (x, y, z) order.
__device__ __forceinline__ void plane_grid_grad(const PlanePoint& pt,
                                                const float dcw[2][4],
                                                float out[3]) {
  const int mask = (pt.ay.m << 1) | pt.ax.m;
  float dwx[2] = {0.f, 0.f}, dwy[2] = {0.f, 0.f}, dwz[2] = {0.f, 0.f};
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dy = j >> 1, dx = j & 1;
      // the fold: raw tap j receives the gradient of the tap it folds onto
      // (static indices keep the array in registers); zeros-masked raw
      // taps receive nothing
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((j & mask) == k) v = dcw[dz][k];
      }
      const float dr = pt.ax.in[dx] && pt.ay.in[dy] && pt.az.in[dz] ? v
                                                                     : 0.f;
      // raw = ((wx * wy) * wz): d_wz from wx * wy, d_wx and d_wy from
      // dr * wz
      dwz[dz] = __fadd_rn(dwz[dz],
                          __fmul_rn(dr, __fmul_rn(pt.ax.w[dx], pt.ay.w[dy])));
      const float drz = __fmul_rn(dr, pt.az.w[dz]);
      dwx[dx] = __fadd_rn(dwx[dx], __fmul_rn(drz, pt.ay.w[dy]));
      dwy[dy] = __fadd_rn(dwy[dy], __fmul_rn(drz, pt.ax.w[dx]));
    }
  }
  // slope is a power of two (or 0): only the product with scale rounds
  out[0] = __fmul_rn(__fmul_rn(__fsub_rn(dwx[1], dwx[0]) * pt.ax.slope,
                               pt.ax.scale), 0.5f);
  out[1] = __fmul_rn(__fmul_rn(__fsub_rn(dwy[1], dwy[0]) * pt.ay.slope,
                               pt.ay.scale), 0.5f);
  out[2] = __fmul_rn(__fmul_rn(__fsub_rn(dwz[1], dwz[0]) * pt.az.slope,
                               pt.az.scale), 0.5f);
}

__global__ void __launch_bounds__(kThreads)
plane_grid_fwd_kernel(const float* __restrict__ img,
                      const float* __restrict__ grid,
                      float* __restrict__ out, int n, int c, int d, int h,
                      int w, int p, int padding, bool align) {
  __shared__ __align__(16) float sgrid[kThreads * 3];
  const int64_t np = (int64_t)n * p;
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int count = (int)min((int64_t)kThreads, np - first);
  stage_in(sgrid, grid + first * 3, count * 3);
  __syncthreads();
  if (threadIdx.x >= count) return;
  const int64_t t = first + threadIdx.x;
  const int64_t ni = t / p, pi = t - ni * p;
  PlanePoint pt;
  plane_point_prep(pt, sgrid + 3 * threadIdx.x, d, h, w, align, padding);
  const int64_t dhw = (int64_t)d * h * w;
  const float* src = img + ni * c * dhw;
  float* dst = out + ni * c * p + pi;
  for (int ci = 0; ci < c; ++ci) {
    float part[2];
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const float* s = src + ci * dhw + pt.tap0[dz];
      // k = 0..3 in order, each product rounded: one flat plane forward
      float acc = __fmul_rn(pt.cw[dz][0], __ldg(s));
      acc = __fadd_rn(acc, __fmul_rn(pt.cw[dz][1],
                                     pt.ok & 2u ? __ldg(s + 1) : 0.f));
      acc = __fadd_rn(acc, __fmul_rn(pt.cw[dz][2],
                                     pt.ok & 4u ? __ldg(s + w) : 0.f));
      acc = __fadd_rn(acc, __fmul_rn(pt.cw[dz][3],
                                     pt.ok & 8u ? __ldg(s + w + 1) : 0.f));
      part[dz] = acc;
    }
    dst[ci * (int64_t)p] = __fadd_rn(part[0], part[1]);
  }
}

// Add a at d_img[i] and b at d_img[i + 1], a row's tap pair, skipping zero
// contributions.  scripts/plane_atomics_bench.py swaps this body for
// Hopper's float4 and float2 atomics to time them.
__device__ __forceinline__ void add_pair(float* __restrict__ d_img,
                                         int64_t i, float a, float b) {
  if (a != 0.f) atomicAdd(d_img + i, a);
  if (b != 0.f) atomicAdd(d_img + i + 1, b);
}

// d_img must be zeroed by the caller.  One thread a point, blocks of
// kThreads points of one batch element.
__global__ void __launch_bounds__(kThreads)
plane_grid_bwd_kernel(const float* __restrict__ g,
                      const float* __restrict__ img,
                      const float* __restrict__ grid,
                      float* __restrict__ d_img, float* __restrict__ d_grid,
                      const float* __restrict__ edge_slope, int n, int c,
                      int d, int h, int w, int p, int padding, bool align) {
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
    PlanePoint pt;
    plane_point_prep(pt, sgrid + 3 * q, d, h, w, align, padding,
                     edge_slope ? __ldg(edge_slope) : 1.f);
    const float* gp = g + ((int64_t)ni * c) * p + p0 + q;
    float dcw[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ci = 0; ci < c; ++ci) {
      const float gv = __ldg(gp + ci * (int64_t)p);
      const int64_t chan = ((int64_t)ni * c + ci) * dhw;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float* s = img + chan + pt.tap0[dz];
        float contrib[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = (pt.ok >> k) & 1u;
          if (ok) {
            const int off = (k >> 1) * w + (k & 1);  // 0, 1, W, W+1
            dcw[dz][k] = __fadd_rn(dcw[dz][k], __fmul_rn(gv, __ldg(s + off)));
          }
          contrib[k] = ok ? __fmul_rn(pt.cw[dz][k], gv) : 0.f;
        }
        // the rows' tap pairs (yx, yx+1) and (yx+W, yx+W+1)
        const int64_t i = chan + pt.tap0[dz];
        add_pair(d_img, i, contrib[0], contrib[1]);
        add_pair(d_img, i + w, contrib[2], contrib[3]);
      }
    }
    float dg[3];
    plane_grid_grad(pt, dcw, dg);
    // this thread alone reads point q's staged grid: overwrite it in place
#pragma unroll
    for (int k = 0; k < 3; ++k) sgrid[3 * q + k] = dg[k];
  }
  __syncthreads();
  stage_out(d_grid + ((int64_t)ni * p + p0) * 3, sgrid, count * 3);
}

// ---------------------------------------------------------- flat pair

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

// padding: 0 zeros, 1 border, 2 reflection, 3 edge; align: 0 or 1.
int advchain_plane_grid_sample_fwd(const float* img, const float* grid,
                                   float* out, int n, int c, int d, int h,
                                   int wd, int p, int padding, int align,
                                   void* stream) {
  if ((int64_t)n * p > 0) {
    plane_grid_fwd_kernel<<<blocks_for(n, p), kThreads, 0,
                            (cudaStream_t)stream>>>(img, grid, out, n, c, d,
                                                    h, wd, p, padding,
                                                    align != 0);
  }
  return (int)cudaGetLastError();
}

// d_img must be zeroed by the caller; d_grid is fully written.  padding 3
// (edge) is border padding whose grid slope at an exact lower bound is
// *edge_slope (one float on the device; null for 1).
int advchain_plane_grid_sample_bwd(const float* g, const float* img,
                                   const float* grid, float* d_img,
                                   float* d_grid, const float* edge_slope,
                                   int n, int c, int d, int h, int wd, int p,
                                   int padding, int align, void* stream) {
  if ((int64_t)n * p > 0) {
    const int blocks = n * ((p + kThreads - 1) / kThreads);
    plane_grid_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g, img, grid, d_img, d_grid, edge_slope, n, c, d, h, wd, p, padding,
        align != 0);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
