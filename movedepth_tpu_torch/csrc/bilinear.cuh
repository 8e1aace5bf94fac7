// Device helpers shared by the port's bilinear-warp kernels: 16-byte vector
// loads and stores of float32 / bfloat16 channel rows, and the four taps of
// a bilinear sample with zeros padding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdt {

// 16 bytes of T as floats: 4 float32 or 8 bfloat16 values.
__device__ __forceinline__ void load16(const float* __restrict__ p,
                                       float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ p,
                                       float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// 16 bytes of T from floats, rounded once.
__device__ __forceinline__ void store16(float* __restrict__ p,
                                        const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* __restrict__ p,
                                        const float* src) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Values of T in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// N values of T from floats, rounded once, N * sizeof(T) <= 16 bytes (4, 8
// or 16 bytes in one store, else one value at a time). p must be aligned to
// N * sizeof(T): a point's N outputs at offset point * N of an aligned
// buffer are.
template <typename T, int N>
__device__ __forceinline__ void store_small(T* __restrict__ p,
                                            const float* src) {
  if constexpr (N * sizeof(T) == 16) {
    store16(p, src);
  } else if constexpr (N == 4 && sizeof(T) == 2) {
    uint2 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(src[0], src[1]);
    h[1] = __floats2bfloat162_rn(src[2], src[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (N == 2 && sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(src[0], src[1]);
  } else if constexpr (N == 2 && sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(src[0], src[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (sizeof(T) == 2)
        p[i] = __float2bfloat16_rn(src[i]);
      else
        p[i] = src[i];
    }
  }
}

// The four taps of a bilinear sample at (x, y) in an R x W image, zeros
// padding: a tap outside [0, W-1] x [0, R-1] is invalid and contributes 0.
// The coordinates are first clamped to [-2, W+1] / [-2, R+1], so any float
// (even inf or a huge value) gives a bounded integer index; the clamp
// changes no valid tap. Weights are in float32 as torch's grid_sample
// computes them: w00 = (1-ax)(1-ay), w01 = ax(1-ay), w10 = (1-ax)ay,
// w11 = ax*ay for the taps (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1).
struct Taps {
  int x0, y0;
  float w[4];
  bool valid[4];
};

__device__ __forceinline__ Taps zeros_taps(float x, float y, int W, int R) {
  x = fminf(fmaxf(x, -2.0f), W + 1.0f);
  y = fminf(fmaxf(y, -2.0f), R + 1.0f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  Taps t;
  t.x0 = static_cast<int>(x0f);
  t.y0 = static_cast<int>(y0f);
  const float ax = x - x0f;
  const float ay = y - y0f;
  t.w[0] = (1.0f - ax) * (1.0f - ay);
  t.w[1] = ax * (1.0f - ay);
  t.w[2] = (1.0f - ax) * ay;
  t.w[3] = ax * ay;
  const bool vx0 = t.x0 >= 0 && t.x0 < W;
  const bool vx1 = t.x0 + 1 >= 0 && t.x0 + 1 < W;
  const bool vy0 = t.y0 >= 0 && t.y0 < R;
  const bool vy1 = t.y0 + 1 >= 0 && t.y0 + 1 < R;
  t.valid[0] = vy0 && vx0;
  t.valid[1] = vy0 && vx1;
  t.valid[2] = vy1 && vx0;
  t.valid[3] = vy1 && vx1;
  return t;
}

// Row-major pixel offset (y * W + x) of tap i of t.
__device__ __forceinline__ long long tap_offset(const Taps& t, int i, int W) {
  return static_cast<long long>(t.y0 + (i >> 1)) * W + t.x0 + (i & 1);
}

}  // namespace mdt
