// Weight and bias gradients of a 3x3x3 Conv3d (stride 1, padding 1, no
// dilation, one group) for Hopper (sm_90a), f32 on the CUDA cores, with no
// float atomics: two runs give the same bits.
//
// Replaces cuDNN's weight gradient of PseudoConv3dModel's two convolutions
// (models/unet.py::ZDecomposedConv3d, an nn.Conv3d): at batch 2 of
// 1x12x192x192 volumes cuDNN picks wgrad2d_grouped_direct_kernel, ~12 ms a
// call and 47.8 ms of an adversarial train step's ~71 busy device ms.  It is
// not a port of a Pallas kernel: the JAX package computes the convolution
// with lax.conv_general_dilated (advchain_tpu/models/unet.py:328-353).
//
// Contract (shared with the plain version in conv3d_wgrad.py):
//   x (N, Cin, D, H, W) and dy (N, Cout, D, H, W), contiguous f32;
//   dW[co, ci, kz, ky, kx] = sum_{n,z,y,x} dy[n, co, z, y, x]
//                              * x[n, ci, z+kz-1, y+ky-1, x+kx-1]
//   (a tap outside the volume reads zero), db[co] = sum dy[n, co, ...].
//
// Bound at the 3D cell's shapes (N=2, 12x192x192 = 884,736 voxels; 67
// TFLOP/s f32, 3.35 TB/s): conv2 (8 -> 4) reads x 28.3 MB + dy 14.2 MB
// (12.7 us) and does 2 x 884,736 x 8 x 4 x 27 = 1.53 GFLOP (22.8 us), so
// 22.8 us; conv1 (1 -> 8) reads 3.5 + 28.3 MB (9.5 us) for 0.38 GFLOP (5.7
// us), so 9.5 us.
//
// Design, two launches:
// 1. conv3d_wgrad_partial_kernel.  A warp's 32 lanes are 32 neighbouring
//    columns of one (n, z) plane; it walks `rows` output rows down them for
//    one unit (one input channel ci and a group of kCo output channels).
//    Each lane keeps the unit's kCo x 27 weight-gradient sums (and kCo bias
//    sums where ci == 0) in registers, and a window of x in registers: the
//    3 x 3 (z, x) taps of the rows y-1, y, y+1 and of the row y+2 in
//    flight, rotated over four buffers so that no register moves.  Per
//    output row a lane loads 9 values of x and kCo of dy (the loads of the
//    next row are issued before this row's arithmetic) and does kCo x 27
//    FMAs: each x value is read once per tap and reused across the kCo
//    output channels.  A block's kWarps warps walk consecutive row runs of
//    one (unit, n, z, 32-column strip); they put their sums in shared memory
//    and each of the block's first 112 threads adds one output's 128 lanes
//    in a fixed order, then writes it to the block's segment of a scratch
//    buffer of (N * D * row blocks * strips) segments of K = Cout * Cin *
//    27 + Cout floats.  The units of a segment write disjoint entries, and
//    every entry of every segment is written.
// 2. conv3d_wgrad_reduce_kernel sums the segments of each of the K entries
//    in a fixed order (eight strided partial sums, then those eight in
//    order) and writes dW and db.
// No float atomics anywhere: the result does not depend on scheduling.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 41, at
// the 3D cell's shapes): conv2 0.148 ms (6.5x its bound), conv1 0.0485 ms
// (5.1x), against 11-13 ms for cuDNN's conv3d_weight on the same inputs;
// the largest gap to a float64 sum is 2.4e-7 of the largest entry (cuDNN:
// 3.6e-6).  The partial kernel takes 205 registers with no spill, so two
// blocks (8 warps) share an SM; capping it at 168 registers (3 blocks)
// spills and takes 11-21% longer, at 128 four times as long.  Runs of 24
// rows a warp were the fastest of 4-96 (16: 0.162 ms at conv2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCo = 4;                    // output channels a lane
constexpr int kTaps = 27;
constexpr int kAcc = kCo * kTaps + kCo;   // a lane's sums: dW's, then db's
constexpr int kWarps = 4;                 // warps a partial block
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kThreads + 1;     // shared row stride: no conflicts
constexpr int kSmemBytes = kAcc * kStride * (int)sizeof(float);
constexpr int kReduceJ = 32, kReduceG = 8;  // the reduce block: 32 x 8

// One x row of the window: the (kz, kx) taps of a lane's column.
struct Row {
  float v[3][3];
};

struct Plane {
  const float* x;   // x[n, ci] (D * H * W values)
  int d, h, w;
  int z, col;       // the output plane and the lane's column
};

__device__ __forceinline__ void load_row(Row& r, const Plane& p, int yy) {
#pragma unroll
  for (int kz = 0; kz < 3; ++kz) {
    const int zz = p.z + kz - 1;
    const bool in = zz >= 0 && zz < p.d && yy >= 0 && yy < p.h;
    const float* row = p.x + (in ? ((int64_t)zz * p.h + yy) * p.w : 0);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int c = p.col + kx - 1;
      r.v[kz][kx] = (in && c >= 0 && c < p.w) ? __ldg(row + c) : 0.f;
    }
  }
}

__device__ __forceinline__ void load_dy(float (&g)[kCo], const float* dy,
                                        int64_t co_stride, int co_left,
                                        bool ok) {
#pragma unroll
  for (int j = 0; j < kCo; ++j) {
    g[j] = (ok && j < co_left) ? __ldg(dy + j * co_stride) : 0.f;
  }
}

// One output row: rows a, b, c are y-1, y, y+1 (ky = 0, 1, 2).
__device__ __forceinline__ void accumulate(float (&acc)[kAcc], const Row& a,
                                           const Row& b, const Row& c,
                                           const float (&g)[kCo]) {
#pragma unroll
  for (int j = 0; j < kCo; ++j) {
#pragma unroll
    for (int kz = 0; kz < 3; ++kz) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int t = j * kTaps + kz * 9 + kx;  // the tap (kz, 0, kx)
        acc[t] = fmaf(g[j], a.v[kz][kx], acc[t]);
        acc[t + 3] = fmaf(g[j], b.v[kz][kx], acc[t + 3]);
        acc[t + 6] = fmaf(g[j], c.v[kz][kx], acc[t + 6]);
      }
    }
    acc[kCo * kTaps + j] += g[j];
  }
}

__global__ void __launch_bounds__(kThreads)
conv3d_wgrad_partial_kernel(const float* __restrict__ x,
                            const float* __restrict__ dy,
                            float* __restrict__ partial, int cin, int cout,
                            int d, int h, int w, int rows, int row_blocks,
                            int strips, int cogs) {
  extern __shared__ float red[];  // [kAcc][kStride]
  const int units = cin * cogs;
  const int unit = blockIdx.x % units;
  const int seg = blockIdx.x / units;
  const int ci = unit / cogs, co0 = (unit % cogs) * kCo;
  const int strip = seg % strips;
  int t = seg / strips;
  const int rb = t % row_blocks;
  t /= row_blocks;
  const int z = t % d, n = t / d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  Plane p;
  p.x = x + ((int64_t)n * cin + ci) * d * h * w;
  p.d = d, p.h = h, p.w = w, p.z = z, p.col = strip * 32 + lane;
  const bool col_ok = p.col < w;
  const int64_t co_stride = (int64_t)d * h * w;
  const float* dyp = dy + (((int64_t)n * cout + co0) * d + z) * h * w + p.col;
  const int co_left = cout - co0;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int y0 = (rb * kWarps + warp) * rows;
  const int y1 = min(y0 + rows, h);
  if (y0 < y1) {
    Row r0, r1, r2, r3;
    float g0[kCo], g1[kCo];
    load_row(r0, p, y0 - 1);
    load_row(r1, p, y0);
    load_row(r2, p, y0 + 1);
    load_dy(g0, dyp + (int64_t)y0 * w, co_stride, co_left, col_ok);
    // four rows a turn, the window's buffers rotating through their roles;
    // each step loads row y+2 and dy of row y+1 before row y's arithmetic
    for (int y = y0;; y += 4) {
      load_row(r3, p, y + 2);
      load_dy(g1, dyp + (int64_t)(y + 1) * w, co_stride, co_left,
              col_ok && y + 1 < y1);
      accumulate(acc, r0, r1, r2, g0);
      if (y + 1 >= y1) break;
      load_row(r0, p, y + 3);
      load_dy(g0, dyp + (int64_t)(y + 2) * w, co_stride, co_left,
              col_ok && y + 2 < y1);
      accumulate(acc, r1, r2, r3, g1);
      if (y + 2 >= y1) break;
      load_row(r1, p, y + 4);
      load_dy(g1, dyp + (int64_t)(y + 3) * w, co_stride, co_left,
              col_ok && y + 3 < y1);
      accumulate(acc, r2, r3, r0, g0);
      if (y + 3 >= y1) break;
      load_row(r2, p, y + 5);
      load_dy(g0, dyp + (int64_t)(y + 4) * w, co_stride, co_left,
              col_ok && y + 4 < y1);
      accumulate(acc, r3, r0, r1, g1);
      if (y + 4 >= y1) break;
    }
  }

  // the block's sums: output i over the 128 lanes, in lane order
#pragma unroll
  for (int i = 0; i < kAcc; ++i) red[i * kStride + threadIdx.x] = acc[i];
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= kAcc) return;
  const float* src = red + i * kStride;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int k = 0; k < kThreads; k += 4) {
    s[0] += src[k];
    s[1] += src[k + 1];
    s[2] += src[k + 2];
    s[3] += src[k + 3];
  }
  const float total = (s[0] + s[1]) + (s[2] + s[3]);
  const int j = i < kCo * kTaps ? i / kTaps : i - kCo * kTaps;
  if (co0 + j >= cout) return;
  const int k_w = cout * cin * kTaps;
  float* out = partial + (int64_t)seg * (k_w + cout);
  if (i < kCo * kTaps) {
    out[((co0 + j) * cin + ci) * kTaps + i % kTaps] = total;
  } else if (ci == 0) {
    out[k_w + co0 + j] = total;
  }
}

__global__ void __launch_bounds__(kReduceJ * kReduceG)
conv3d_wgrad_reduce_kernel(const float* __restrict__ partial, int segs,
                           int k, float* __restrict__ dw,
                           float* __restrict__ db, int k_w) {
  __shared__ float part[kReduceG][kReduceJ];
  const int jl = threadIdx.x % kReduceJ, g = threadIdx.x / kReduceJ;
  const int j = blockIdx.x * kReduceJ + jl;
  float s = 0.f;
  if (j < k) {
    for (int seg = g; seg < segs; seg += kReduceG) {
      s += partial[(int64_t)seg * k + j];
    }
  }
  part[g][jl] = s;
  __syncthreads();
  if (g != 0 || j >= k) return;
  float total = part[0][jl];
#pragma unroll
  for (int q = 1; q < kReduceG; ++q) total += part[q][jl];
  if (j < k_w) {
    dw[j] = total;
  } else {
    db[j - k_w] = total;
  }
}

}  // namespace

extern "C" {

// The scratch floats a call with these sizes needs: the partial kernel's
// segments times K = cout * cin * 27 + cout (0 for sizes the call refuses).
int64_t advchain_conv3d_wgrad_scratch(int n, int cin, int cout, int d, int h,
                                      int w, int rows) {
  if (rows < 1 || n < 1 || cin < 1 || cout < 1 || d < 1 || h < 1 || w < 1) {
    return 0;
  }
  const int row_blocks = (h + kWarps * rows - 1) / (kWarps * rows);
  const int strips = (w + 31) / 32;
  return (int64_t)n * d * row_blocks * strips * (cout * cin * kTaps + cout);
}

// Two launches on `stream`: the partial sums into `partial` (the floats
// advchain_conv3d_wgrad_scratch gives), then their reduction into dw
// (cout, cin, 3, 3, 3) and db (cout).  `rows`: output rows a warp walks.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for sizes the
// launch grid cannot hold).
int advchain_conv3d_wgrad(const float* x, const float* dy, float* partial,
                          float* dw, float* db, int n, int cin, int cout,
                          int d, int h, int w, int rows, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows < 1 || n < 1 || cin < 1 || cout < 1 || d < 1 || h < 1 || w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int row_blocks = (h + kWarps * rows - 1) / (kWarps * rows);
  const int strips = (w + 31) / 32;
  const int cogs = (cout + kCo - 1) / kCo;
  const int64_t segs = (int64_t)n * d * row_blocks * strips;
  const int64_t blocks = segs * cin * cogs;
  const int64_t k = (int64_t)cout * cin * kTaps + cout;
  if (blocks >= (1ll << 31) || segs * k >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  // the partial kernel's shared memory exceeds the default 48 KB: raise
  // its limit once per device
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(conv3d_wgrad_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }
  conv3d_wgrad_partial_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, s>>>(
      x, dy, partial, cin, cout, d, h, w, rows, row_blocks, strips, cogs);
  conv3d_wgrad_reduce_kernel<<<(unsigned)((k + kReduceJ - 1) / kReduceJ),
                               kReduceJ * kReduceG, 0, s>>>(
      partial, (int)segs, (int)k, dw, db, (int)(cout * cin * kTaps));
  return (int)cudaGetLastError();
}

}  // extern "C"
