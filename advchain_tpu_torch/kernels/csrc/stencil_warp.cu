// Near-identity 2D warp for Hopper (sm_90a): bilinear sampling with border
// padding and align_corners=True at a channel-first grid, forward and its
// analytic backward; and the flow compositions' dispatch predicate.
//
// Replaces the TPU kernels advchain_tpu/kernels/stencil.py::
// _stencil_fwd_2d_pallas and ::_stencil_bwd_2d_pallas (the custom VJP of
// ops/grid_sample.py::stencil_warp_2d).  The TPU versions edge-pad the image
// by R pixels, sum (2R+1)^2 static taps built from lane/sublane rolls of a
// VMEM-resident frame, and return the unfolded transposed stencil for the
// caller to fold.  Here each output pixel reads its four taps at CLAMPED
// rows and columns, which equals the edge-padded frame within R pixels and
// stays exact bilinear-with-border for any displacement, so the caller
// needs no radius bound and no fold.
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
//   each times `lower_slope` where its coordinate lies exactly on the lower
//   bound (xpix == 0: 1 is the stencil's one-sided slope, 0.5 the sampler's
//   clip), d_flow = (d_fx (W-1)/2, d_fy (H-1)/2) written per pixel, and
//   d_img[s] = sum of wy * wx * g over the taps that land on s (a collapsed
//   tap sums both weights, the exact transpose of edge padding; a tap of
//   weight 0 adds nothing).
// The arithmetic is written with __fmul_rn / __fadd_rn so that nvcc does not
// contract it into FMAs: a coordinate that rounds differently can flip
// floor() to another tap, which scaling and squaring then amplifies.
//
// Bound: both kernels move bytes, not operations (9 flops per (pixel,
// channel) forward, 24 backward).  At the headline's compositions (N=128,
// C=2, H=W=192) the forward must read img + flow and write out: 3 x 37.7 MB
// = 113 MB, 0.034 ms at 3.35 TB/s; the backward must read g + img + flow
// and write d_img + d_flow: 5 x 37.7 MB = 189 MB, 0.056 ms.
//
// Forward design: one thread per output pixel (n, y, x), looping over C; a
// warp's threads read neighbouring flow values and, for near-identity
// grids, neighbouring image pixels, so the loads coalesce and the image
// stays in L2.
//
// Backward design: owner computes, as the TPU kernel's transposed stencil.
// 1. stencil_warp_bwd_gather: a block owns a 32 x 8 tile of pixels of one
//    image.  Each thread loads the flow and CH channels of the cotangent of
//    two output pixels p of the tile and its kWindow-pixel halo, and the
//    cotangent and four image taps of its own pixel (every load in flight
//    at once).  For each tap of p of weight != 0 within kWindow of p that
//    lands in the tile it writes the tap's weight (a collapsed tap sums both)
//    times g to shared memory and sets the bit of p's offset in that source
//    pixel's candidate mask (shared atomicOr: the result does not depend on
//    the order).  Each thread then sums the contributions of its own
//    pixel's set bits in ascending order and stores d_img with a plain
//    store (no float atomics: d_img is the same bit for bit from run to
//    run), and writes its own pixel's d_flow (one writer a pixel).
// 2. stencil_warp_bwd_outliers adds the taps farther than kWindow from their
//    own pixel (on either axis), which the gather left out and counted, with
//    global atomics once every gather is done; it returns at once when the
//    count is 0.  Both kernels decide "in window" by the same integer test,
//    so each tap is counted once.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/stencil_bwd_bench.py
// at the headline call, N=128, C=2, 192 x 192, a flow jittered by up to 1.9
// px): this design at 64 registers (four blocks an SM) takes 0.203 ms, and
// 0.179 ms on a smooth squaring input of a headline morph; a tile of 32 x 16
// or 64 x 8, a cap of 48 registers, and a window of 1 or 3 pixels were
// slower (a window of 1 sends this flow's 2-px taps to the atomics, one of 3
// tests 49 candidates).  Earlier designs were slower: testing all kSpan^2
// candidates of each source pixel with a byte compare (0.35-0.37 ms, with
// d_flow written by the gather or by a kernel of its own), and these masks
// beside a d_flow kernel of its own (0.227 ms).  The scatter it replaces (one thread a pixel, 4C global
// atomics, after zeroing d_img) took 0.292 + 0.011 ms here and 0.126 +
// 0.011 ms on the smooth input, where neighbouring atomics coalesce: the
// gather buys a fixed summation order, not speed on smooth flows, which are
// what the scaling and squaring feeds it.
//
// The dispatch predicate (dispatch_slope_kernel) is the JAX package's
// lax.cond predicate in compose_flow (ops/integrate.py:103-116, 134-141):
// dpx = max over axes of max |flow - base| (S - 1) / 2, and the slope at an
// exact lower bound is 1 (the stencil's) where dpx < R - 1e-3, else 0.5 (the
// sampler's).  One launch after the caller zeroes the call's two work
// words: each block folds its maximum into the first with atomicMax on the
// f32 bits (non-negative floats order as their bits; a NaN's bits exceed
// every number's, so a NaN flow takes the sampler, as in JAX) and counts
// itself done in the second; the last block to finish writes the slope.
// The words belong to the call, so launches on other streams do not mix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileX = 32, kTileY = 8;  // the gather: a source pixel a thread
constexpr int kTileThreads = kTileX * kTileY;
constexpr int kTailBlocks = 132 * 4;    // row-loop kernels: 4 blocks an SM
// The gather's window: the taps within kWindow pixels of their own pixel on
// both axes (the JAX stencil's radius).
constexpr int kWindow = 2;
constexpr int kSpan = 2 * kWindow + 1;

struct Axis {
  int i0, i1;  // clamped taps
  float f;     // fraction of the unclipped coordinate
  bool lo;     // the coordinate lies exactly on the lower bound
};

__device__ __forceinline__ Axis axis_taps(float g, int size) {
  // (g + 1) * 0.5 * (size - 1), each step rounded as the plain version does
  const float pix = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f),
                              (float)(size - 1));
  const float fl = floorf(pix);
  Axis a;
  a.f = __fsub_rn(pix, fl);
  a.lo = pix == 0.f;
  // the taps no longer change below -1 or above size-1; clamping in float
  // first keeps the int conversion in range (fmaxf maps NaN to -1)
  const int i = (int)fminf(fmaxf(fl, -1.f), (float)(size - 1));
  a.i0 = max(i, 0);
  a.i1 = min(i + 1, size - 1);
  return a;
}

struct Taps {
  Axis x, y;
  int o00, o01, o10, o11;    // flat offsets of the four clamped taps (an
                             // image plane holds fewer than 2^31 pixels)
  float wx0, wx1, wy0, wy1;  // hat weights
};

__device__ __forceinline__ Taps pixel_taps(const float* fp, int64_t hw,
                                           int h, int w) {
  Taps t;
  t.x = axis_taps(fp[0], w);
  t.y = axis_taps(fp[hw], h);
  t.o00 = t.y.i0 * w + t.x.i0;
  t.o01 = t.y.i0 * w + t.x.i1;
  t.o10 = t.y.i1 * w + t.x.i0;
  t.o11 = t.y.i1 * w + t.x.i1;
  t.wx0 = __fsub_rn(1.f, t.x.f);
  t.wx1 = t.x.f;
  t.wy0 = __fsub_rn(1.f, t.y.f);
  t.wy1 = t.y.f;
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

// ------------------------------------------------------------- backward
// The candidate mask of a source pixel: bit (ey + kWindow) kSpan + ex +
// kWindow is set when the output pixel at s - (ey, ex) has a tap of weight
// != 0 on s.
using Mask = unsigned;
static_assert(kSpan * kSpan <= 32, "a candidate mask holds kSpan^2 bits");

// Is tap `i` of a pixel at `p` within the window?  The one test both
// kernels use.
__device__ __forceinline__ bool in_window(int i, int p) {
  return abs(i - p) <= kWindow;
}

// A staged output pixel: its flow and CH channels of its cotangent.
template <int CH>
struct Staged {
  float fx, fy, g[CH];
};

// Stage the output pixel at halo index q (image pixel (py, px)) for the
// tile at (ty, tx): for each distinct tap (a collapsed +1 tap adds its
// weight to the base tap's) of weight != 0 in the window of p that lands in
// tile, write its weight times the CH channels to s_c[(2a + b) CH + k][q]
// (a, b: the tap's row and column offsets from p's base tap) and, with
// `mark`, set the bit of p's offset in that source pixel's mask and p's
// base offsets in s_base[q].
template <int CH, int HALO>
__device__ __forceinline__ void stage_pixel(
    const Staged<CH>& sp, int q, int py, int px, int ty, int tx, int h, int w,
    bool mark, unsigned* s_base, float (*s_c)[HALO], Mask* s_mask) {
  const Axis ax = axis_taps(sp.fx, w), ay = axis_taps(sp.fy, h);
  const float wy0 = __fsub_rn(1.f, ay.f), wx0 = __fsub_rn(1.f, ax.f);
  const float wy[2] = {ay.i1 != ay.i0 ? wy0 : __fadd_rn(wy0, ay.f), ay.f};
  const float wx[2] = {ax.i1 != ax.i0 ? wx0 : __fadd_rn(wx0, ax.f), ax.f};
  const int dy[2] = {ay.i0 - py, ay.i1 - py};
  const int dx[2] = {ax.i0 - px, ax.i1 - px};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wt = __fmul_rn(wy[a], wx[b]);
      const int sy = py + dy[a] - ty, sx = px + dx[b] - tx;
      if (wt == 0.f || (a && dy[1] == dy[0]) || (b && dx[1] == dx[0]) ||
          !in_window(dy[a], 0) || !in_window(dx[b], 0) || sy < 0 ||
          sy >= kTileY || sx < 0 || sx >= kTileX) {
        continue;
      }
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        s_c[(2 * a + b) * CH + k][q] = __fmul_rn(wt, sp.g[k]);
      }
      if (mark) {
        atomicOr(s_mask + sy * kTileX + sx,
                 Mask(1) << ((dy[a] + kWindow) * kSpan + dx[b] + kWindow));
      }
    }
  }
  if (mark) {
    s_base[q] = ((unsigned)min(max(dy[0], -127), 127) & 0xff) |
                ((unsigned)min(max(dx[0], -127), 127) & 0xff) << 8;
  }
}

// The backward of a 32 x 8 tile: d_img by the gather, d_flow of its pixels;
// counts their taps outside the window into *outside.
template <int CH>
__global__ void __launch_bounds__(kTileThreads, 1024 / kTileThreads)
stencil_warp_bwd_gather(const float* __restrict__ g,
                        const float* __restrict__ img,
                        const float* __restrict__ flow,
                        const float* __restrict__ lower_slope,
                        float* __restrict__ d_img, float* __restrict__ d_flow,
                        int* __restrict__ outside, int c, int h, int w) {
  constexpr int HX = kTileX + 2 * kWindow, HY = kTileY + 2 * kWindow;
  constexpr int HALO = HX * HY;
  // the pixels a thread stages
  constexpr int PER = (HALO + kTileThreads - 1) / kTileThreads;
  __shared__ unsigned s_base[HALO];   // bytes y0 - py and x0 - px
  __shared__ float s_c[4 * CH][HALO];
  __shared__ Mask s_mask[kTileThreads];
  __shared__ int s_outside[kTileThreads / 32];

  const int tiles_x = (w + kTileX - 1) / kTileX;
  const int tiles_y = (h + kTileY - 1) / kTileY;
  const int tile = blockIdx.x % (tiles_x * tiles_y);
  const int64_t ni = blockIdx.x / (tiles_x * tiles_y);
  const int tx = (tile % tiles_x) * kTileX, ty = (tile / tiles_x) * kTileY;
  const int64_t hw = (int64_t)h * w;
  const float* fl = flow + ni * 2 * hw;
  const float* gn = g + ni * c * hw;
  const float* src = img + ni * c * hw;
  s_mask[threadIdx.x] = 0;

  // this thread's staged pixels q = threadIdx.x + j kTileThreads: their
  // image offsets (-1 outside the image), flows and cotangents
  int pis[PER];
  Staged<CH> sp[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int q = threadIdx.x + j * kTileThreads;
    const int py = ty - kWindow + q / HX, px = tx - kWindow + q % HX;
    pis[j] = q < HALO && py >= 0 && py < h && px >= 0 && px < w
                 ? py * w + px : -1;
    if (pis[j] >= 0) {
      sp[j].fx = __ldg(fl + pis[j]);
      sp[j].fy = __ldg(fl + hw + pis[j]);
    }
  }
  // this thread's own pixel: a source pixel of the tile and the output
  // pixel whose d_flow it writes
  const int lx = threadIdx.x % kTileX, ly = threadIdx.x / kTileX;
  const bool own = tx + lx < w && ty + ly < h;
  const int si = (ty + ly) * w + tx + lx;
  const int centre = (ly + kWindow) * HX + lx + kWindow;
  Taps tp;
  if (own) tp = pixel_taps(fl + si, hw, h, w);
  // per-row sums over channels: g * (v_r1 - v_r0) and g * inner_r
  float gx0 = 0.f, gx1 = 0.f, gy0 = 0.f, gy1 = 0.f;
  for (int c0 = 0; c0 < c; c0 += CH) {
    const int kc = min(CH, c - c0);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        sp[j].g[k] = pis[j] >= 0 && k < kc
                         ? __ldg(gn + (c0 + k) * hw + pis[j]) : 0.f;
      }
    }
    float gv[CH], v[CH][4];  // the own pixel's cotangent and image taps
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (own && k < kc) {
        const float* s = src + (c0 + k) * hw;
        gv[k] = __ldg(gn + (c0 + k) * hw + si);
        v[k][0] = __ldg(s + tp.o00);
        v[k][1] = __ldg(s + tp.o01);
        v[k][2] = __ldg(s + tp.o10);
        v[k][3] = __ldg(s + tp.o11);
      }
    }
    __syncthreads();  // the masks are zeroed; the previous chunk is consumed
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (pis[j] < 0) continue;
      const int q = threadIdx.x + j * kTileThreads;
      stage_pixel<CH, HALO>(sp[j], q, ty - kWindow + q / HX,
                            tx - kWindow + q % HX, ty, tx, h, w, c0 == 0,
                            s_base, s_c, s_mask);
    }
    __syncthreads();
    if (!own) continue;
    float acc[CH] = {};
    // the candidates in ascending bit order: a fixed summation order
    for (Mask m = s_mask[threadIdx.x]; m; m &= m - 1) {
      const int bit = __ffs((int)m) - 1;
      const int ey = bit / kSpan - kWindow, ex = bit % kSpan - kWindow;
      const int q = centre - ey * HX - ex;
      const unsigned base = s_base[q];
      const int a = ey - (int)(signed char)(base & 0xff);
      const int b = ex - (int)(signed char)((base >> 8) & 0xff);
      const float* cp = s_c[(2 * a + b) * CH] + q;
#pragma unroll
      for (int k = 0; k < CH; ++k) acc[k] = __fadd_rn(acc[k], cp[k * HALO]);
    }
    float* dst = d_img + (ni * c + c0) * hw + si;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (k >= kc) break;
      dst[k * hw] = acc[k];
      gx0 = __fadd_rn(gx0, __fmul_rn(gv[k], __fsub_rn(v[k][1], v[k][0])));
      gx1 = __fadd_rn(gx1, __fmul_rn(gv[k], __fsub_rn(v[k][3], v[k][2])));
      gy0 = __fadd_rn(gy0, __fmul_rn(gv[k], row_lerp(tp, v[k][0], v[k][1])));
      gy1 = __fadd_rn(gy1, __fmul_rn(gv[k], row_lerp(tp, v[k][2], v[k][3])));
    }
  }

  int out_taps = 0;  // the own pixel's taps of weight != 0 outside the window
  if (own) {
    float d_fx = __fadd_rn(__fmul_rn(tp.wy0, gx0), __fmul_rn(tp.wy1, gx1));
    float d_fy = __fsub_rn(gy1, gy0);
    const float slope = lower_slope ? __ldg(lower_slope) : 1.f;
    if (tp.x.lo) d_fx = __fmul_rn(d_fx, slope);
    if (tp.y.lo) d_fy = __fmul_rn(d_fy, slope);
    float* dfp = d_flow + ni * 2 * hw + si;
    dfp[0] = __fmul_rn(d_fx, 0.5f * (float)(w - 1));
    dfp[hw] = __fmul_rn(d_fy, 0.5f * (float)(h - 1));
    const int py = ty + ly, px = tx + lx;
    const bool iy[2] = {in_window(tp.y.i0, py), in_window(tp.y.i1, py)};
    const bool ix[2] = {in_window(tp.x.i0, px), in_window(tp.x.i1, px)};
    const float wy[2] = {tp.wy0, tp.wy1}, wx[2] = {tp.wx0, tp.wx1};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        out_taps += !(iy[a] && ix[b]) && __fmul_rn(wy[a], wx[b]) != 0.f;
      }
    }
  }
  out_taps = __reduce_add_sync(0xffffffffu, out_taps);
  if ((threadIdx.x & 31) == 0) s_outside[threadIdx.x >> 5] = out_taps;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kTileThreads / 32; ++i) total += s_outside[i];
    if (total) atomicAdd(outside, total);
  }
}

// The taps the gather left out, added with atomics once every gather is
// done; idle unless the gather counted some.  A warp a row at a time.
__global__ void __launch_bounds__(kThreads)
stencil_warp_bwd_outliers(const float* __restrict__ g,
                          const float* __restrict__ flow,
                          const int* __restrict__ outside,
                          float* __restrict__ d_img, int n, int c, int h,
                          int w) {
  constexpr int kWarps = kThreads / 32;
  if (*outside == 0) return;
  const int64_t hw = (int64_t)h * w;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < n * h;
       row += gridDim.x * kWarps) {
    const int py = row % h;
    const int64_t ni = row / h;
    for (int px = threadIdx.x & 31; px < w; px += 32) {
      const int pi = py * w + px;
      const Taps tp = pixel_taps(flow + ni * 2 * hw + pi, hw, h, w);
      const bool iy[2] = {in_window(tp.y.i0, py), in_window(tp.y.i1, py)};
      const bool ix[2] = {in_window(tp.x.i0, px), in_window(tp.x.i1, px)};
      if (iy[0] && iy[1] && ix[0] && ix[1]) continue;
      const float wy[2] = {tp.wy0, tp.wy1}, wx[2] = {tp.wx0, tp.wx1};
      const int off[2][2] = {{tp.o00, tp.o01}, {tp.o10, tp.o11}};
      const float* gp = g + ni * c * hw + pi;
      float* dsrc = d_img + ni * c * hw;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float wt = __fmul_rn(wy[a], wx[b]);
          if ((iy[a] && ix[b]) || wt == 0.f) continue;
          for (int ci = 0; ci < c; ++ci) {
            atomicAdd(dsrc + ci * hw + off[a][b],
                      __fmul_rn(wt, __ldg(gp + ci * hw)));
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ predicate
// work[0]: the maximum's bits over the blocks done so far; work[1]: the
// blocks done.  Both zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
dispatch_slope_kernel(const float* __restrict__ flow,
                      const float* __restrict__ base,
                      float* __restrict__ out, unsigned* __restrict__ work,
                      int n, int dims, int d, int h, int w, float threshold) {
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned s_max[kWarps];
  const int64_t hw = (int64_t)h * w, vol = d * hw;
  const float sx = 0.5f * (float)(w - 1), sy = 0.5f * (float)(h - 1);
  const float sz = 0.5f * (float)(d - 1);
  const int lane = threadIdx.x & 31, rows = n * d * h;
  unsigned bits = 0u;
  // a warp a row (image, z, y) at a time, its lanes along x
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kWarps) {
    const int y = row % h, z = row / h % d, ni = row / h / d;
    const float* f = flow + (int64_t)ni * dims * vol + z * hw + (int64_t)y * w;
    const float by = __ldg(base + w + y), bz = __ldg(base + w + h + z);
    for (int x = lane; x < w; x += 32) {
      // |u| (S - 1) / 2 per axis; the max commutes with the scaling, as
      // rounding is monotone
      bits = max(bits, __float_as_uint(__fmul_rn(
          fabsf(__fsub_rn(__ldg(f + x), __ldg(base + x))), sx)));
      bits = max(bits, __float_as_uint(__fmul_rn(
          fabsf(__fsub_rn(__ldg(f + vol + x), by)), sy)));
      if (dims == 3) {
        bits = max(bits, __float_as_uint(__fmul_rn(
            fabsf(__fsub_rn(__ldg(f + 2 * vol + x), bz)), sz)));
      }
    }
  }
  bits = __reduce_max_sync(0xffffffffu, bits);
  if (lane == 0) s_max[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) bits = max(bits, s_max[i]);
  atomicMax(work, bits);
  __threadfence();
  if (atomicAdd(work + 1, 1u) == gridDim.x - 1) {
    // every other block's atomicMax is done and visible
    const float dpx = __uint_as_float(atomicMax(work, 0u));
    out[0] = dpx < threshold ? 1.f : 0.5f;
    out[1] = dpx;
  }
}

int blocks_for(int64_t count) {
  return (int)((count + kThreads - 1) / kThreads);
}

// The grid of a kernel that takes a row a warp: one row a warp, at most
// kTailBlocks blocks (the rows loop).
int row_blocks(int64_t rows) {
  const int64_t need = (rows + kThreads / 32 - 1) / (kThreads / 32);
  return (int)(need < kTailBlocks ? need : kTailBlocks);
}

template <int CH>
void launch_bwd(const float* g, const float* img, const float* flow,
                const float* lower_slope, float* d_img, float* d_flow,
                int* outside, int n, int c, int h, int w,
                cudaStream_t stream) {
  const int tiles = ((w + kTileX - 1) / kTileX) * ((h + kTileY - 1) / kTileY);
  stencil_warp_bwd_gather<CH><<<n * tiles, kTileThreads, 0, stream>>>(
      g, img, flow, lower_slope, d_img, d_flow, outside, c, h, w);
  stencil_warp_bwd_outliers<<<row_blocks((int64_t)n * h), kThreads, 0,
                              stream>>>(g, flow, outside, d_img, n, c, h, w);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int advchain_stencil_warp_fwd(const float* img, const float* flow, float* out,
                              int n, int c, int h, int w, void* stream) {
  if ((int64_t)n * h * w > 0) {
    stencil_warp_fwd_kernel<<<blocks_for((int64_t)n * h * w), kThreads, 0,
                              (cudaStream_t)stream>>>(img, flow, out, n, c, h,
                                                      w);
  }
  return (int)cudaGetLastError();
}

// Two launches: the gather (d_img within the window, d_flow), then the taps
// outside it.  d_img and d_flow are fully written; `outside` (one int,
// zeroed by the caller) receives the number of taps of weight != 0 farther
// than kWindow pixels from their own pixel; `lower_slope` (one float, or
// null for 1) scales d_flow where a coordinate lies exactly on the lower
// bound.  The channels are staged in chunks of C itself up to 2, else 4.
int advchain_stencil_warp_bwd(const float* g, const float* img,
                              const float* flow, const float* lower_slope,
                              float* d_img, float* d_flow, int* outside,
                              int n, int c, int h, int w, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if ((int64_t)n * h * w > 0) {
    if (c == 1) {
      launch_bwd<1>(g, img, flow, lower_slope, d_img, d_flow, outside, n, c,
                    h, w, s);
    } else if (c == 2) {
      launch_bwd<2>(g, img, flow, lower_slope, d_img, d_flow, outside, n, c,
                    h, w, s);
    } else {
      launch_bwd<4>(g, img, flow, lower_slope, d_img, d_flow, outside, n, c,
                    h, w, s);
    }
  }
  return (int)cudaGetLastError();
}

// flow (N, dims, [D,] H, W) with dims 2 (d = 1) or 3; base: the base grid's
// coordinates along W, then H, then D; work: two words of this call, zeroed
// by the caller.  Writes out[0] = the slope at an exact lower bound (1 where
// dpx < threshold, else 0.5) and out[1] = dpx.
int advchain_dispatch_slope(const float* flow, const float* base, float* out,
                            unsigned* work, int n, int dims, int d, int h,
                            int w, float threshold, void* stream) {
  const int64_t rows = (int64_t)n * d * h;
  if (rows * w > 0) {
    dispatch_slope_kernel<<<row_blocks(rows), kThreads, 0,
                            (cudaStream_t)stream>>>(flow, base, out, work, n,
                                                    dims, d, h, w, threshold);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
