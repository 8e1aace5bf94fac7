// The plane-sweep warp-correlate kernel of sweep_warp_corr.cu, templated
// on a stage mask so that sweep_warp_corr_variants.cu can time it with one
// stage taken out. The shipped kernel is the instantiation with no stage
// skipped (kSkip = 0); the others compute wrong results by design.
#pragma once

#include "bilinear.cuh"

namespace mdt_swc {

// Stages a variant skips (bit mask).
enum Skip : int {
  kNoGather = 1,     // every tap reads one fixed address (pixel 0)
  kNoWeights = 2,    // every tap weighs 1/4 (no bilinear weight math)
  kNoCorrelate = 4,  // no product with ref (ref is not read)
  kNoReduce = 8,     // store the first channel of each group, no group sum
};

template <typename T, int C>
__device__ __forceinline__ void add_tap(const T* __restrict__ p, float w,
                                        float (&acc)[C]) {
  float v[C];
  mdt::load_row<T, C>(p, v);
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = fmaf(w, v[c], acc[c]);
}

constexpr int kThreads = 128;

// src (B,R,W,C), ref (B,H,W,C), sx/sy (B,D,H,W) f32 -> out (B,D,H,W,G).
template <typename T, int C, int G, int kSkip = 0>
__global__ void __launch_bounds__(kThreads)
    sweep_warp_corr_kernel(const T* __restrict__ src,
                           const T* __restrict__ ref,
                           const float* __restrict__ sx,
                           const float* __restrict__ sy, T* __restrict__ out,
                           int B, int R, int W, int D, int H) {
  static_assert(C % G == 0, "groups must divide channels");
  const long long n = static_cast<long long>(B) * H * W;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = static_cast<int>(i % W);
  const long long bh = i / W;  // b * H + h
  const int h = static_cast<int>(bh % H);
  const int b = static_cast<int>(bh / H);

  float r[C];
  if constexpr ((kSkip & kNoCorrelate) == 0)
    mdt::load_row<T, C>(ref + i * C, r);
  const T* __restrict__ s = src + static_cast<long long>(b) * R * W * C;
  constexpr float kInvK = static_cast<float>(G) / static_cast<float>(C);

  for (int d = 0; d < D; ++d) {
    const long long p = ((static_cast<long long>(b) * D + d) * H + h) * W + x;
    const mdt::Taps t = mdt::zeros_taps(sx[p], sy[p], W, R);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!t.valid[k]) continue;
      const T* tap =
          (kSkip & kNoGather) != 0 ? s : s + mdt::tap_offset(t, k, W) * C;
      add_tap<T, C>(tap, (kSkip & kNoWeights) != 0 ? 0.25f : t.w[k], acc);
    }

    // correlate, then the group mean over k under the (k*G + g) order
    float o[G];
    if constexpr ((kSkip & kNoReduce) != 0) {
      // the other channels' sums stay computed: only the reduction goes
#pragma unroll
      for (int c = G; c < C; ++c) asm volatile("" : : "f"(acc[c]));
#pragma unroll
      for (int g = 0; g < G; ++g)
        o[g] = (kSkip & kNoCorrelate) != 0 ? acc[g] : acc[g] * r[g];
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) o[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if constexpr ((kSkip & kNoCorrelate) != 0)
          o[c % G] += acc[c];
        else
          o[c % G] = fmaf(acc[c], r[c], o[c % G]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) o[g] *= kInvK;
    }
    mdt::store_row<T, G>(out + p * G, o);
  }
}

}  // namespace mdt_swc
