// The sampling grid's per-axis coordinate prep, shared by the grid-level
// samplers (band_sample.cu in 2D, zband_sample.cu in 3D): unnormalise a
// normalised coordinate (torch grid_sample convention), reflect and clip it
// per padding mode, and floor it to the clipped base corner, the hat
// weights, the collapse indicator and the zeros-padding masks; the slope
// and scale carry d coordinate / d grid for the closed-form backward.
// Each step is rounded as the plain PyTorch version's
// (kernels/_coords.py::prep_coord) with __fmul_rn / __fadd_rn, so nvcc does
// not contract it into FMAs: a coordinate that rounds differently can flip
// floor() to another tap.

#pragma once

#include <cuda_runtime.h>

namespace grid_coords {

// kEdge: border padding whose slope at an exact lower bound is a runtime
// `edge_slope` (the 3D flow compositions: 1, the edge-padded stencil's
// one-sided difference, or 0.5, the sampler's clip, as JAX's dispatch
// picks); its values are border padding's.
enum Padding { kZeros = 0, kBorder = 1, kReflection = 2, kEdge = 3 };

// jnp.clip's subgradient: the factor minimum(maximum(v, lo), hi) passes,
// `lo_tie` (jnp.clip's 0.5) at v == lo
__device__ __forceinline__ float clip_slope(float v, float lo, float hi,
                                            float lo_tie = 0.5f) {
  const float a = v > lo ? 1.f : (v == lo ? lo_tie : 0.f);
  const float m = fmaxf(v, lo);
  return a * (m < hi ? 1.f : (m == hi ? 0.5f : 0.f));
}

struct Axis {
  int i0;       // clipped base corner (nearest: the clipped rounded one)
  int m;        // 1 when the clipped +1 tap differs from the base
  float w[2];   // hat weights 1 - f and f
  bool in[2];   // zeros padding: unclipped taps x0 and x0 + 1 in [0, S-1]
  float slope;  // d coord / d unnormalised coord (a power of two or 0)
  float scale;  // S - 1 (align_corners) or S: d_g = d_coord slope scale / 2
};

__device__ __forceinline__ Axis axis_prep(float g, int size, bool align,
                                          int padding, bool nearest,
                                          float edge_slope = 1.f) {
  Axis a;
  const float hi = (float)(size - 1);
  // _unnormalize, each step rounded as the plain version's
  float c;
  if (align) {
    a.scale = hi;
    c = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f), hi);
  } else {
    a.scale = (float)size;
    c = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), (float)size), 1.f),
                  0.5f);
  }
  a.slope = 1.f;
  if (padding == kReflection) {
    const float low = align ? 0.f : -0.5f;
    const float span = align ? hi : (float)size;
    if (span <= 0.f) {  // one voxel with align_corners: the plain zeros_like
      c = 0.f;
      a.slope = 0.f;
    } else {
      float x = __fsub_rn(c, low);
      if (!(x >= 0.f)) {  // |.| as a select: slope 1 at 0, as jnp.abs's
        x = -x;
        a.slope = -a.slope;
      }
      const float two = 2.f * span;
      x = fmodf(x, two);  // exact, as torch.remainder for x >= 0
      if (x > span) {
        x = __fsub_rn(two, x);
        a.slope = -a.slope;
      }
      c = __fadd_rn(x, low);
    }
  }
  if (padding != kZeros) {
    a.slope *= clip_slope(c, 0.f, hi, padding == kEdge ? edge_slope : 0.5f);
    c = fminf(fmaxf(c, 0.f), hi);
  }
  if (nearest) {
    const float r = rintf(c);  // half to even, as torch.round / jnp.round
    a.in[0] = padding != kZeros || (r >= 0.f && r <= hi);
    a.in[1] = false;
    a.i0 = (int)fminf(fmaxf(r, 0.f), hi);
    a.m = 0;
    a.w[0] = 1.f;
    a.w[1] = 0.f;
    return a;
  }
  const float x0 = floorf(c);
  const float x1 = __fadd_rn(x0, 1.f);
  const float f = __fsub_rn(c, x0);
  a.w[0] = __fsub_rn(1.f, f);
  a.w[1] = f;
  // the float clamp keeps the int conversion in range (NaN maps to 0)
  const float x0c = fminf(fmaxf(x0, 0.f), hi);
  const float x1c = fminf(fmaxf(x1, 0.f), hi);
  a.i0 = (int)x0c;
  a.m = x1c != x0c;
  a.in[0] = padding != kZeros || (x0 >= 0.f && x0 <= hi);
  a.in[1] = padding != kZeros || (x1 >= 0.f && x1 <= hi);
  return a;
}

}  // namespace grid_coords
