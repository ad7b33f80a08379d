// The backward of training-mode batch normalisation of an NCHW f32 tensor
// for Hopper (sm_90a), with no float atomics: every sum is taken in a fixed
// order, so two runs give the same bits.
//
// Replaces cuDNN's NCHW per-channel backward (bn_bw_1C11_kernel_new) under
// models/unet.py::_FrozenStats._normalize for the 2D models in training
// mode; the forward stays the library's (batch_norm.py says why), and this
// pair reads the mean and invstd it saved.  It is not a port of a Pallas
// kernel: the JAX package leaves BatchNorm to Flax and XLA.
//
// Contract (shared with the plain version in batch_norm.py): x and dy
// (N, C, S), contiguous NCHW tensors with S = H * W, M = N * S values a
// channel, mean and invstd the forward's saved statistics;
//   dx = w invstd (dy - sum(dy) / M - xhat sum(dy xhat) / M),
//   dw = sum(dy xhat), db = sum(dy), xhat = (x - mean) invstd.
// w may be absent (1); dw, db and dx are each written only where a pointer
// is given.
//
// Bound: memory.  The backward must read dy and x twice (the sums, then
// dx) and write dx once; at UNet_16's widest layer (N = 128, C = 16,
// 192 x 192: 302 MB a tensor) that is 0.450 ms at 3.35 TB/s.
//
// Design, two launches, on a grid of (row chunk, channel): the chunks of a
// channel split its N * S values (as N rows of S) evenly, and the wrapper
// picks as many chunks as let every block of the grid be resident at once
// (advchain_batch_norm_resident), so each launch is one wave of equal
// blocks.  Each thread reads 16 bytes a load (where S and the pointers
// allow, else 4), four loads in flight.
// 1. batch_norm_grad_reduce_kernel: each block's sums of dy and
//    dy * (x - mean) over its chunk, in a fixed tree.
// 2. batch_norm_grad_input_kernel: each block folds its channel's partials
//    in chunk order and writes its chunk of dx; the first chunk's block
//    writes dw and db.  With no dx it runs one block a channel, for dw and
//    db alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // loads in flight a thread

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, off);
    v.y += __shfl_down_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// The values of channel c as V-wide vectors: vector v of the channel lies at
// row v / sv (the batch index), column v % sv, of the (N, C, S) tensor.
template <int V>
struct Channel {
  int c, ch, sv;  // the channel, the channel count, vectors a row
  __device__ __forceinline__ int64_t offset(int v) const {
    const int n = v / sv;
    return ((int64_t)n * ch + c) * sv * V + (int64_t)(v - n * sv) * V;
  }
};

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
  } else {
    r[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *p = r[0];
  }
}

// the block's chunk [*v0, *v1) of a channel's `total` vectors
__device__ __forceinline__ void chunk_range(int total, int* v0, int* v1) {
  const int per = (total + gridDim.x - 1) / gridDim.x;
  *v0 = min((int)blockIdx.x * per, total);
  *v1 = min(*v0 + per, total);
}

// Visit each vector v of the block's chunk once, kUnroll loads in flight a
// thread: f(v, a's values, b's values).
template <int V, typename F>
__device__ __forceinline__ void for_chunk(const Channel<V>& chan, int v0,
                                          int v1, const float* __restrict__ a,
                                          const float* __restrict__ b, F f) {
  int v = v0 + threadIdx.x;
  for (; v + (kUnroll - 1) * kThreads < v1; v += kUnroll * kThreads) {
    float ra[kUnroll][V], rb[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = chan.offset(v + u * kThreads);
      load<V>(a + off, ra[u]);
      load<V>(b + off, rb[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f(v + u * kThreads, ra[u], rb[u]);
  }
  for (; v < v1; v += kThreads) {
    float ra[V], rb[V];
    const int64_t off = chan.offset(v);
    load<V>(a + off, ra);
    load<V>(b + off, rb);
    f(v, ra, rb);
  }
}

__device__ __forceinline__ float2 fold_sums(const float* __restrict__ p,
                                            int chunks) {
  float2 s = make_float2(0.f, 0.f);
  for (int k = threadIdx.x; k < chunks; k += 32) {
    s.x += p[2 * k];
    s.y += p[2 * k + 1];
  }
  return warp_sum(s);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_grad_reduce_kernel(const float* __restrict__ x,
                              const float* __restrict__ dy,
                              const float* __restrict__ mean, int ch, int sv,
                              int total, float* __restrict__ partial) {
  const Channel<V> chan{(int)blockIdx.y, ch, sv};
  const float mu = mean[chan.c];
  int v0, v1;
  chunk_range(total, &v0, &v1);
  float2 s = make_float2(0.f, 0.f);
  for_chunk<V>(chan, v0, v1, dy, x,
               [&](int, const float (&g)[V], const float (&r)[V]) {
#pragma unroll
                 for (int i = 0; i < V; ++i) {
                   s.x += g[i];
                   s.y = fmaf(g[i], r[i] - mu, s.y);
                 }
               });
  s = warp_sum(s);
  __shared__ float2 warps[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warps[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = warps[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) t.x += warps[k].x, t.y += warps[k].y;
    float* out = partial + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * 2;
    out[0] = t.x, out[1] = t.y;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_grad_input_kernel(const float* __restrict__ x,
                             const float* __restrict__ dy,
                             const float* __restrict__ mean,
                             const float* __restrict__ invstd,
                             const float* __restrict__ w,
                             const float* __restrict__ partial, int chunks,
                             int ch, int sv, int total, int64_t m_count,
                             float* __restrict__ dx, float* __restrict__ dw,
                             float* __restrict__ db) {
  const int c = blockIdx.y;
  __shared__ float coef[3];  // scale, mean of dy, slope of (x - mean)
  if (threadIdx.x < 32) {
    const float2 t = fold_sums(partial + (int64_t)c * chunks * 2, chunks);
    if (threadIdx.x == 0) {
      const float is = invstd[c];
      coef[0] = w == nullptr ? is : w[c] * is;
      coef[1] = t.x / (float)m_count;
      coef[2] = is * is * t.y / (float)m_count;
      if (blockIdx.x == 0) {
        if (dw != nullptr) dw[c] = t.y * is;
        if (db != nullptr) db[c] = t.x;
      }
    }
  }
  if (dx == nullptr) return;
  __syncthreads();
  const float scale = coef[0], mdy = coef[1], slope = coef[2];
  const float mu = mean[c];
  const Channel<V> chan{c, ch, sv};
  int v0, v1;
  chunk_range(total, &v0, &v1);
  for_chunk<V>(chan, v0, v1, dy, x,
               [&](int v, const float (&g)[V], const float (&r)[V]) {
                 float o[V];
#pragma unroll
                 for (int i = 0; i < V; ++i)
                   o[i] = scale * ((g[i] - mdy) - (r[i] - mu) * slope);
                 store<V>(dx + chan.offset(v), o);
               });
}

bool bad_shape(int n, int c, int s, int chunks, int vec) {
  return n <= 0 || c <= 0 || c > 65535 || s <= 0 || chunks <= 0 ||
         (vec != 1 && vec != 4) || s % vec != 0 ||
         (int64_t)n * c * s >= ((int64_t)1 << 31);
}

template <int V>
int resident() {
  int a = 0, b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &a, batch_norm_grad_reduce_kernel<V>, kThreads, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, batch_norm_grad_input_kernel<V>, kThreads, 0);
  return a < b ? a : b;
}

}  // namespace

extern "C" {

// The blocks of kThreads that the current device holds at once, on all its
// SMs, for the pair's two kernels at this vector width; 0 where the query
// fails.
int advchain_batch_norm_resident(int vec) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms * (vec == 4 ? resident<4>() : resident<1>());
}

// dx (where given), dw and db (where given) in two launches; partial holds
// C * chunks * 2 floats.
int advchain_batch_norm_bwd(const float* x, const float* dy,
                            const float* mean, const float* invstd,
                            const float* w, float* dx, float* dw, float* db,
                            float* partial, int n, int c, int s, int chunks,
                            int vec, cudaStream_t stream) {
  if (bad_shape(n, c, s, chunks, vec)) return (int)cudaErrorInvalidValue;
  const int sv = s / vec, total = n * sv;
  const int64_t m = (int64_t)n * s;
  const dim3 grid(chunks, c), grid_dx(dx == nullptr ? 1 : chunks, c);
  if (vec == 4) {
    batch_norm_grad_reduce_kernel<4><<<grid, kThreads, 0, stream>>>(
        x, dy, mean, c, sv, total, partial);
    batch_norm_grad_input_kernel<4><<<grid_dx, kThreads, 0, stream>>>(
        x, dy, mean, invstd, w, partial, chunks, c, sv, total, m, dx, dw, db);
  } else {
    batch_norm_grad_reduce_kernel<1><<<grid, kThreads, 0, stream>>>(
        x, dy, mean, c, sv, total, partial);
    batch_norm_grad_input_kernel<1><<<grid_dx, kThreads, 0, stream>>>(
        x, dy, mean, invstd, w, partial, chunks, c, sv, total, m, dx, dw, db);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
