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
//    plane kernels.  The 2D route's bilinear backward, K = 4 at the tap
//    square (0, 1, W, W+1), takes the corner tile backward
//    (corner_tile_sample_bwd), which sums coincident taps in shared memory
//    before its global atomics.
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
// Bound: every kernel here moves bytes, not operations.  The grid-level pair
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
//
// The corner tile backward (corner_tile_sample_bwd): the corner backward
// the 2D route's bilinear calls make, K = 4 at the tap square (0, 1, W,
// W+1), with the output raster's width.  At the image warps' call (N=128,
// C=1, 192x192, a 30-degree rotation) the flat backward must move 226 MB
// (0.068 ms at 3.35 TB/s; w and d_w are 151 MB of it, fixed by the
// contract), but it issues one scattered global atomic per nonzero tap,
// 3.4 a point on the rotation and 4.0 on a near-identity warp, and those
// took 0.116 of its 0.197 ms on an H100 (scripts/corner_bwd_bench.py,
// PERF.md).  Points that share a source pixel must add before L2: a block
// takes an 8 x 32 tile of the output raster (a small rotated rectangle in
// the source), sums every tap into a shared box of the tile's source
// rectangle, and flushes each nonzero cell with one global atomic, a warp
// to a box row, so neighbouring lanes add to neighbouring addresses: 1.02
// global atomics a point on the rotation, 1.29 on the near-identity warp
// (16 x 16 tiles need 0.98 and 1.23, but their half-warp rows load and
// store more slowly).
// Hopper's f32 (and int64) atomicAdd in shared memory compiles to a
// compare-and-swap loop and its int32 add is native, so the box holds
// fixed point: each tap adds two int32 parts of its contribution scaled to
// the block's largest, exact to 2^-38 of it and independent of the order
// of the adds.  The merge plan (each point's box cell and tap validity)
// depends on idx alone and serves every channel; d_w stays one writer a
// point, from the same tap loads.  K=1 (nearest) and other offsets take
// the flat backward.  The flushes of neighbouring tiles meet in L2 in no
// fixed order, so d_img matches its plain version to f32 reassociation.

#include <climits>
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

// ----------------------------------------------- corner tile backward
constexpr int kWarps = kThreads / 32;
constexpr int kBoxCells = 1024;  // cells of a block's shared source box
// a tap's contribution in units of 2^-kFixBits of the block's largest
// contribution bound, split at bit kLoBits into two int32 adds: a block
// adds at most 4 * kThreads taps to a cell, so neither sum overflows
constexpr int kFixBits = 38;
constexpr int kLoBits = 19;

// x * 2^e for e in [-90, 186], as two exact power-of-two products
__device__ __forceinline__ float scale_pow2(float x, int e) {
  const int e1 = e >> 1, e2 = e - e1;
  return __fmul_rn(__fmul_rn(x, __int_as_float((127 + e1) << 23)),
                   __int_as_float((127 + e2) << 23));
}

// The flat backward at the bilinear tap square off = (0, 1, stride,
// stride + 1), over a raster of width wo (p = ho * wo).  A block owns a
// th x tw tile of the raster (th * tw = kThreads, tw = 2^tw_log2, 8 x 32
// unless the raster is narrower or one row) of one batch element, one
// point a thread, so a warp's loads and d_w stores cover one raster row.  The
// merge plan, once per point: its base split into image row and column
// (floor division by stride) and its tap validity.  The block's box is the
// least (row, column) rectangle that holds every tap of every point with a
// valid tap.  A tap's cell is its (row, column) in the box, so the +1 tap
// of a last-column base sits one column past the image and flushes to the
// next row's first pixel, as the flat contract says.  Per channel, where
// the box fits in kBoxCells and the block's contributions are finite, each
// tap adds its contribution in fixed point, scaled by 2^kFixBits over the
// block's largest |contribution| rounded up to a power of two, as two
// int32 shared atomics (the high part, floor(y / 2^kLoBits), and the low
// part in [0, 2^kLoBits]): Hopper adds int32 in shared memory natively,
// where a float or int64 add is a compare-and-swap loop.  The sums are
// exact integers, so the order of the adds does not matter; each nonzero
// cell is then scaled back to f32 and flushed with one global atomic, a
// warp to a box row, and reset to zero for the next channel.  Otherwise
// the block adds each tap with a global atomic.  Capped at 40 registers
// (six blocks an SM), which spills nothing.  d_img must be zeroed by the
// caller; d_w is fully written.
__global__ void __launch_bounds__(kThreads, 6)
corner_tile_bwd_kernel(const float* __restrict__ g,
                       const float* __restrict__ img,
                       const int* __restrict__ idx,
                       const float* __restrict__ wts,
                       float* __restrict__ d_img, float* __restrict__ d_w,
                       int c, int s, int p, int wo, int stride, int tw_log2,
                       int tiles_x, int tiles) {
  __shared__ __align__(16) int box_hi[kBoxCells];
  __shared__ __align__(16) unsigned box_lo[kBoxCells];
  // per warp: the bounds, then each channel's largest |contribution| in
  // slot 4 + (channel & 1), so that no channel overwrites the slot the
  // last one is still reading
  __shared__ int warp_bounds[kWarps][6];
  const int ni = blockIdx.x / tiles;
  const int tile = blockIdx.x - ni * tiles;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int ho = p / wo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the whole box, in 16-byte stores (zeroing only the box's own cells
  // after the bounds costs registers: it spilled under the cap and was
  // slower); each flush resets the cells it reads
  for (int j = threadIdx.x; j < kBoxCells / 4; j += kThreads) {
    reinterpret_cast<int4*>(box_hi)[j] = make_int4(0, 0, 0, 0);
    reinterpret_cast<int4*>(box_lo)[j] = make_int4(0, 0, 0, 0);
  }

  const int th = kThreads >> tw_log2;
  const int r = ty * th + (threadIdx.x >> tw_log2);
  const int col = (tx << tw_log2) + (threadIdx.x & ((1 << tw_log2) - 1));
  const int pt = r < ho && col < wo ? r * wo + col : -1;
  int b = 0, rb = 0, cb = 0;
  unsigned ok = 0u;
  float wk[4] = {0.f, 0.f, 0.f, 0.f};
  if (pt >= 0) {
    b = __ldg(idx + (int64_t)ni * p + pt);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t f = (int64_t)b + (k >> 1) * (int64_t)stride + (k & 1);
      if (f >= 0 && f < s) ok |= 1u << k;
      wk[k] = __ldg(wts + ((int64_t)ni * 4 + k) * p + pt);
    }
    rb = b / stride;
    if (rb * stride > b) --rb;  // floor, for negative bases too
    cb = b - rb * stride;
  }
  const bool live = ok != 0u;
  int bounds[4] = {live ? rb : INT_MAX, live ? -rb : INT_MAX,
                   live ? cb : INT_MAX, live ? -cb : INT_MAX};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bounds[j] = __reduce_min_sync(0xffffffffu, bounds[j]);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) warp_bounds[warp][j] = bounds[j];
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
#pragma unroll
    for (int j = 0; j < 4; ++j) bounds[j] = min(bounds[j], warp_bounds[w][j]);
  }
  // taps reach one row and one column past the bases
  const int64_t box_h = -(int64_t)bounds[1] - bounds[0] + 2;
  const int64_t box_w = -(int64_t)bounds[3] - bounds[2] + 2;
  const bool fits = bounds[0] != INT_MAX && box_h * box_w <= kBoxCells;
  const int bw = fits ? (int)box_w : 0;
  const int cell = fits && live ? (rb - bounds[0]) * bw + (cb - bounds[2])
                                : 0;

  float dw[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ci = 0; ci < c; ++ci) {
    const int64_t chan = (int64_t)ni * c + ci;
    const float* sp = img + chan * s;
    float* dp = d_img + chan * s;
    const float gv = live ? __ldg(g + chan * p + pt) : 0.f;
    float contrib[4];
    float most = 0.f;  // the largest |contrib|; NaN and inf order above
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool valid = (ok >> k) & 1u;
      if (valid) {
        const int f = b + (k >> 1) * stride + (k & 1);
        dw[k] = __fadd_rn(dw[k], __fmul_rn(gv, __ldg(sp + f)));
      }
      contrib[k] = valid ? __fmul_rn(wk[k], gv) : 0.f;
      most = __uint_as_float(max(__float_as_uint(most),
                                 __float_as_uint(fabsf(contrib[k]))));
    }
    const unsigned most_bits = __reduce_max_sync(0xffffffffu,
                                                 __float_as_uint(most));
    const int slot = 4 + (ci & 1);
    if (lane == 0) warp_bounds[warp][slot] = (int)most_bits;
    // also: the last channel's flush has read and reset the box
    __syncthreads();
    unsigned block_most = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      block_most = max(block_most, (unsigned)warp_bounds[w][slot]);
    }
    if (block_most == 0u) continue;  // nothing to add
    const bool use_box = fits && block_most < 0x7f800000u;
    int ex = 0;
    frexpf(__uint_as_float(block_most), &ex);  // |contrib| < 2^ex
    const int up = kFixBits - ex;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (contrib[k] == 0.f) continue;  // and so the tap is valid
      if (use_box) {
        const float y = scale_pow2(contrib[k], up);  // |y| < 2^kFixBits
        const float hi = floorf(__fmul_rn(y, 1.f / (1 << kLoBits)));
        const int at = cell + (k >> 1) * bw + (k & 1);
        atomicAdd(box_hi + at, (int)hi);
        atomicAdd(box_lo + at, __float2uint_rn(
            __fsub_rn(y, __fmul_rn(hi, (float)(1 << kLoBits)))));
      } else {
        atomicAdd(dp + b + (k >> 1) * stride + (k & 1), contrib[k]);
      }
    }
    if (!use_box) continue;
    __syncthreads();
    // one global atomic per nonzero cell; a cell that received nothing is
    // zero, one that received a tap lies in [0, s)
    for (int rr = warp; rr < (int)box_h; rr += kWarps) {
      const int64_t row0 = (int64_t)(bounds[0] + rr) * stride + bounds[2];
      for (int j = lane; j < bw; j += 32) {
        const int at = rr * bw + j;
        const int hi = box_hi[at];
        const unsigned lo = box_lo[at];
        if (hi == 0 && lo == 0u) continue;
        box_hi[at] = 0;
        box_lo[at] = 0u;
        const int64_t sum = (int64_t)hi * (1 << kLoBits) + lo;
        if (sum != 0) {
          atomicAdd(dp + row0 + j, scale_pow2(__ll2float_rn(sum), -up));
        }
      }
    }
  }
  if (pt >= 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d_w[((int64_t)ni * 4 + k) * p + pt] = dw[k];
    }
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

// The corner backward at the tap square (0, 1, stride, stride + 1) over a
// raster of width wo, which must divide p; img (N, C, S).  d_img must be
// zeroed by the caller; d_w is fully written.
int advchain_corner_tile_sample_bwd(const float* g, const float* img,
                                    const int* idx, const float* w,
                                    float* d_img, float* d_w, int n, int c,
                                    int s, int p, int wo, int stride,
                                    void* stream) {
  if (wo < 1 || p % wo != 0 || stride < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)n * p > 0) {
    // a tile of 8 x 32 points, or of one row when the raster is one row
    const int ho = p / wo, cap = ho == 1 ? 8 : 5;
    int tw_log2 = 0;
    while ((1 << tw_log2) < wo && tw_log2 < cap) ++tw_log2;
    const int th = kThreads >> tw_log2;
    const int tiles_x = (wo + (1 << tw_log2) - 1) >> tw_log2;
    const int64_t tiles = (int64_t)tiles_x * ((ho + th - 1) / th);
    if (tiles * n > INT_MAX) return (int)cudaErrorInvalidValue;
    corner_tile_bwd_kernel<<<(int)(n * tiles), kThreads, 0,
                             (cudaStream_t)stream>>>(g, img, idx, w, d_img,
                                                     d_w, c, s, p, wo,
                                                     stride, tw_log2,
                                                     tiles_x, (int)tiles);
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
