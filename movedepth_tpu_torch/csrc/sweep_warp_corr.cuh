// The plane-sweep warp-correlate kernel of sweep_warp_corr.cu, templated
// on a stage mask so that sweep_warp_corr_variants.cu can time it with one
// stage taken out. The shipped kernel is the instantiation with no stage
// skipped (kSkip = 0); the others compute wrong results by design.
#pragma once

#include "bilinear.cuh"

namespace mdt_swc {

// Stages a variant skips (bit mask).
enum Skip : int {
  kNoGather = 1,     // every tap reads one fixed address (the lane's chunk
                     // of source pixel 0)
  kNoWeights = 2,    // every tap weighs 1/4 (no bilinear weight math)
  kNoCorrelate = 4,  // no product with ref (ref is not read)
  kNoReduce = 8,     // no shuffle: each lane stores its own partial sums
};

constexpr int kThreads = 128;
// Planes a thread walks (one plane group). Blocks of one pixel tile and
// neighbouring plane groups have neighbouring indices, so they run
// together and read the tile's reference chunks and source taps from L2.
constexpr int kPlanes = 8;

__host__ __device__ constexpr int plane_groups(int D) {
  return (D + kPlanes - 1) / kPlanes;
}

// src (B,R,W,C), ref (B,H,W,C), sx/sy (B,D,H,W) f32 -> out (B,D,H,W,G).
// L = C / V lanes own one point, each a 16-byte chunk of V channels;
// grid: (pixel tiles x plane groups), a tile kThreads / L pixels of a row.
template <typename T, int C, int G, int kSkip = 0>
__global__ void __launch_bounds__(kThreads)
    sweep_warp_corr_kernel(const T* __restrict__ src,
                           const T* __restrict__ ref,
                           const float* __restrict__ sx,
                           const float* __restrict__ sy, T* __restrict__ out,
                           int B, int R, int W, int D, int H) {
  constexpr int V = mdt::Vec<T>::N;
  constexpr int L = C / V;
  static_assert(C % V == 0 && 32 % L == 0, "C must be V, 2V, ... 32V");
  static_assert(C % G == 0, "groups must divide channels");
  constexpr float kInvK = static_cast<float>(G) / static_cast<float>(C);

  constexpr int kCols = kThreads / L;
  const int groups = plane_groups(D);
  const int tiles_x = (W + kCols - 1) / kCols;
  const long long tile = blockIdx.x / groups;
  const int d0 = static_cast<int>(blockIdx.x % groups) * kPlanes;
  const int lane = threadIdx.x % L;
  const long long bh_ = tile / tiles_x;  // b * H + h
  const int x_ = static_cast<int>(tile % tiles_x) * kCols + threadIdx.x / L;
  const int h_ = static_cast<int>(bh_ % H);
  const int b_ = static_cast<int>(bh_ / H);
  const bool live = b_ < B && x_ < W;
  // dead lanes follow pixel 0 and store nothing: every lane of a warp
  // takes part in the shuffles
  const int x = live ? x_ : 0;
  const int h = live ? h_ : 0;
  const int b = live ? b_ : 0;
  const long long q = (static_cast<long long>(b) * H + h) * W + x;

  float r[V];
  if constexpr ((kSkip & kNoCorrelate) == 0)
    mdt::load16(ref + q * C + lane * V, r);
  const T* __restrict__ s =
      src + static_cast<long long>(b) * R * W * C + lane * V;

#pragma unroll
  for (int dd = 0; dd < kPlanes; ++dd) {
    const int d = d0 + dd;
    if (d >= D) break;
    const long long p = ((static_cast<long long>(b) * D + d) * H + h) * W + x;
    const mdt::Taps t = mdt::zeros_taps(sx[p], sy[p], W, R);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!t.valid[k]) continue;
      float v[V];
      mdt::load16((kSkip & kNoGather) != 0
                      ? s
                      : s + mdt::tap_offset(t, k, W) * C,
                  v);
      const float wk = (kSkip & kNoWeights) != 0 ? 0.25f : t.w[k];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(wk, v[j], acc[j]);
    }
    if constexpr ((kSkip & kNoCorrelate) == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] *= r[j];
    }

    // the group mean over k under the (k*G + g) order: channel lane*V + j
    // belongs to group (lane*V + j) % G
    T* __restrict__ o = out + p * G;
    if constexpr (G >= V) {
      // lanes lane, lane ^ G/V, lane ^ 2G/V, ... hold the same V groups
      if constexpr ((kSkip & kNoReduce) == 0) {
#pragma unroll
        for (int m = G / V; m < L; m <<= 1)
#pragma unroll
          for (int j = 0; j < V; ++j)
            acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] *= kInvK;
      if (live && lane < G / V) mdt::store16(o + lane * V, acc);
    } else {
      // one lane holds V / G channels of every group
      float sum[G];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) sum[gg] = acc[gg];
#pragma unroll
      for (int j = G; j < V; ++j) sum[j % G] += acc[j];
      if constexpr ((kSkip & kNoReduce) == 0) {
#pragma unroll
        for (int m = 1; m < L; m <<= 1)
#pragma unroll
          for (int gg = 0; gg < G; ++gg)
            sum[gg] += __shfl_xor_sync(0xffffffffu, sum[gg], m);
      }
#pragma unroll
      for (int gg = 0; gg < G; ++gg) sum[gg] *= kInvK;
      if (live && lane == 0) mdt::store_small<T, G>(o, sum);
    }
  }
}

// Blocks of a launch over B*H*W pixels and D planes.
template <typename T, int C>
inline unsigned grid_blocks(int B, int H, int W, int D) {
  constexpr int kCols = kThreads / (C / mdt::Vec<T>::N);
  const long long tiles =
      static_cast<long long>(B) * H * ((W + kCols - 1) / kCols);
  return static_cast<unsigned>(tiles * plane_groups(D));
}

}  // namespace mdt_swc
