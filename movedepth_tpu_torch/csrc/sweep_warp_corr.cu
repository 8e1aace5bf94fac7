// Plane-sweep cost volume in one kernel: bilinear warp, correlate, group mean.
//
// Replaces the Pallas TPU kernel movedepth_tpu/ops/pallas/sweep_warp.py::
// sweep_warp_corr (_warp_corr_kernel / _sweep_body). Same contract:
//
//   out[b,d,h,x,g] = (G/C) * sum_k ref[b,h,x,k*G+g] * warp[b,d,h,x,k*G+g]
//   warp[b,d,h,x,:] = bilinear sample of src[b] at (sx, sy)[b,d,h,x]
//
// with zeros padding (a tap outside [0,W-1]x[0,R-1] contributes 0), tap
// weights in f32 as torch's grid_sample computes them, f32 accumulation and
// one rounding to the output dtype. Coordinates are clamped to [-2, W+1] /
// [-2, R+1] before the floor, as the TPU kernel does, so any float gives a
// bounded integer index.
//
// Design. The TPU kernel builds one-hot selection matrices and runs the
// gather as matmuls because the TPU has no vector gather; Hopper gathers
// natively, so this is a plain gather kernel. One thread owns one output
// pixel (b, h, x) and loops over the D depth hypotheses: ref[b,h,x,:] is
// read once into registers and reused D times. Each tap reads its C source
// channels with 16-byte vector loads; neighbouring threads hold neighbouring
// x, so coordinate reads and the G-wide output rows are coalesced.
//
// What bounds it: HBM traffic. At the shipped B=128, D=16, H=R=48, W=160,
// C=32, G=16 in bf16 it writes 128*16*48*160*16*2 B = 503 MB and reads 126
// MB of f32 coordinates; the 4 taps re-read the 63 MB of source features
// D times, mostly from L2 because neighbouring threads share taps. The
// arithmetic is ~5*C FMAs per point. No wgmma and no TMA: there
// is no matrix product here, and staging tiles through shared memory with
// TMA is left for a later optimisation, as is computing sx/sy in-kernel from
// the depth bins (which would remove the coordinate reads).

#include "bilinear.cuh"

namespace {

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
template <typename T, int C, int G>
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
    for (int k = 0; k < 4; ++k)
      if (t.valid[k]) add_tap<T, C>(s + mdt::tap_offset(t, k, W) * C, t.w[k], acc);

    // correlate, then the group mean over k under the (k*G + g) order
    float o[G];
#pragma unroll
    for (int g = 0; g < G; ++g) o[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c % G] = fmaf(acc[c], r[c], o[c % G]);
#pragma unroll
    for (int g = 0; g < G; ++g) o[g] *= kInvK;
    mdt::store_row<T, G>(out + p * G, o);
  }
}

// The (C, G) pairs compiled in: the FPN's matching widths at prior scales
// 0-3 (8, 16, 32, 64 channels) against the usual group counts.
#define SWC_PAIRS(X)                                                  \
  X(8, 4) X(8, 8) X(16, 4) X(16, 8) X(16, 16) X(32, 4) X(32, 8)      \
      X(32, 16) X(32, 32) X(64, 4) X(64, 8) X(64, 16) X(64, 32)

template <typename T>
int launch(const void* src, const void* ref, const void* sx, const void* sy,
           void* out, int B, int R, int W, int D, int H, int C, int G,
           cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * H * W;
  if (n == 0 || D == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
#define SWC_CASE(c, g)                                                    \
  if (C == c && G == g) {                                                 \
    sweep_warp_corr_kernel<T, c, g><<<grid, kThreads, 0, stream>>>(       \
        static_cast<const T*>(src), static_cast<const T*>(ref),           \
        static_cast<const float*>(sx), static_cast<const float*>(sy),     \
        static_cast<T*>(out), B, R, W, D, H);                             \
    return static_cast<int>(cudaGetLastError());                          \
  }
  SWC_PAIRS(SWC_CASE)
#undef SWC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int sweep_warp_corr_supported(int C, int G) {
#define SWC_SUPPORTED(c, g) \
  if (C == c && G == g) return 1;
  SWC_PAIRS(SWC_SUPPORTED)
#undef SWC_SUPPORTED
  return 0;
}

int sweep_warp_corr_f32(const void* src, const void* ref, const void* sx,
                        const void* sy, void* out, int B, int R, int W, int D,
                        int H, int C, int G, void* stream) {
  return launch<float>(src, ref, sx, sy, out, B, R, W, D, H, C, G,
                       static_cast<cudaStream_t>(stream));
}

int sweep_warp_corr_bf16(const void* src, const void* ref, const void* sx,
                         const void* sy, void* out, int B, int R, int W,
                         int D, int H, int C, int G, void* stream) {
  return launch<__nv_bfloat16>(src, ref, sx, sy, out, B, R, W, D, H, C, G,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
