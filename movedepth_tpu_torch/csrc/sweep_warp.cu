// Plane-sweep feature warp for training: forward and source gradient.
//
// Replaces the Pallas TPU kernels of movedepth_tpu/ops/pallas/sweep_warp.py:
//   * sweep_warp (forward, _warp_rows_call / _warp_kernel):
//       out[b,d,h,x,:] = bilinear sample of src[b] at (sx, sy)[b,d,h,x]
//     with zeros padding (a tap outside [0,W-1]x[0,R-1] contributes 0),
//     float32 tap weights and accumulation, one rounding to src's dtype;
//   * _warp_rows_bwd_impl (the custom VJP, _warp_bwd_kernel):
//       dsrc[b,r,q,:] = sum over (d,h,x) and taps landing on (r,q) of
//                       w_tap * g[b,d,h,x,:]
//     in float32. The coordinates get no gradient.
// Coordinates are clamped to [-2, W+1] / [-2, R+1] before the floor, as
// the TPU kernels do (bilinear.cuh).
//
// Design. The TPU kernels express the gather and its transpose as one-hot
// matmuls because a TPU cannot gather or scatter; Hopper does both
// natively. One thread owns one 16-byte channel chunk (4 float32 or 8
// bfloat16 channels) of one output point (b, d, h, x): neighbouring threads
// hold neighbouring chunks and then neighbouring x, so the coordinate
// reads, the tap reads and the output (or gradient) rows are coalesced.
// The backward scatters with float32 atomicAdd (16-byte float4 atomics,
// sm_90) into a zeroed (B,R,W,C) buffer that the wrapper allocates and
// casts afterwards; the summation order, and so the last bits of dsrc, vary
// from run to run.
//
// What bounds it: HBM traffic. At the shipped train shape (B=12, D=16,
// H=R=48, W=160, C=32, bfloat16) the forward writes 94 MB and reads 5.9 MB
// of source features (D times over, from L2) and 5.9 MB of coordinates;
// the backward reads the 94 MB gradient and issues 4*C float32 atomics per
// point into an 11.8 MB buffer that stays in the 50 MB L2.

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;

// src (B,R,W,C) T, sx/sy (B,D,H,W) f32 -> out (B,D,H,W,C) T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sweep_warp_fwd_kernel(const T* __restrict__ src,
                          const float* __restrict__ sx,
                          const float* __restrict__ sy, T* __restrict__ out,
                          long long n, int R, int W, int DHW, int C) {
  constexpr int V = mdt::Vec<T>::N;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int chunks = C / V;
  const long long p = i / chunks;  // ((b*D + d)*H + h)*W + x
  const int c0 = static_cast<int>(i % chunks) * V;
  const long long b = p / DHW;
  const mdt::Taps t = mdt::zeros_taps(sx[p], sy[p], W, R);
  const T* __restrict__ s = src + b * R * W * C + c0;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!t.valid[k]) continue;
    float v[V];
    mdt::load16(s + mdt::tap_offset(t, k, W) * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = fmaf(t.w[k], v[j], acc[j]);
  }
  mdt::store16(out + p * C + c0, acc);
}

// g (B,D,H,W,C) T, sx/sy (B,D,H,W) f32 -> dsrc (B,R,W,C) f32 (pre-zeroed).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sweep_warp_bwd_kernel(const T* __restrict__ g,
                          const float* __restrict__ sx,
                          const float* __restrict__ sy,
                          float* __restrict__ dsrc, long long n, int R, int W,
                          int DHW, int C) {
  constexpr int V = mdt::Vec<T>::N;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int chunks = C / V;
  const long long p = i / chunks;
  const int c0 = static_cast<int>(i % chunks) * V;
  const long long b = p / DHW;
  const mdt::Taps t = mdt::zeros_taps(sx[p], sy[p], W, R);
  if (!(t.valid[0] || t.valid[1] || t.valid[2] || t.valid[3])) return;

  float gv[V];
  mdt::load16(g + p * C + c0, gv);
  float* __restrict__ d = dsrc + b * R * W * C + c0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!t.valid[k]) continue;
    float* __restrict__ q = d + mdt::tap_offset(t, k, W) * C;
    // Hopper adds a 16-byte float4 atomically: one instruction per 4
    // channels (q is 16-byte aligned: C and c0 are multiples of 4)
#pragma unroll
    for (int j = 0; j < V; j += 4)
      atomicAdd(reinterpret_cast<float4*>(q + j),
                make_float4(t.w[k] * gv[j], t.w[k] * gv[j + 1],
                            t.w[k] * gv[j + 2], t.w[k] * gv[j + 3]));
  }
}

template <typename T>
int launch_fwd(const void* src, const void* sx, const void* sy, void* out,
               int B, int R, int W, int D, int H, int C,
               cudaStream_t stream) {
  if (C <= 0 || C % mdt::Vec<T>::N) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * D * H * W * (C / mdt::Vec<T>::N);
  if (n == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  sweep_warp_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const float*>(sx),
      static_cast<const float*>(sy), static_cast<T*>(out), n, R, W, D * H * W,
      C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g, const void* sx, const void* sy, void* dsrc,
               int B, int R, int W, int D, int H, int C,
               cudaStream_t stream) {
  if (C <= 0 || C % mdt::Vec<T>::N) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * D * H * W * (C / mdt::Vec<T>::N);
  if (n == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  sweep_warp_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const float*>(sx),
      static_cast<const float*>(sy), static_cast<float*>(dsrc), n, R, W,
      D * H * W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sweep_warp_fwd_f32(const void* src, const void* sx, const void* sy,
                       void* out, int B, int R, int W, int D, int H, int C,
                       void* stream) {
  return launch_fwd<float>(src, sx, sy, out, B, R, W, D, H, C,
                           static_cast<cudaStream_t>(stream));
}

int sweep_warp_fwd_bf16(const void* src, const void* sx, const void* sy,
                        void* out, int B, int R, int W, int D, int H, int C,
                        void* stream) {
  return launch_fwd<__nv_bfloat16>(src, sx, sy, out, B, R, W, D, H, C,
                                   static_cast<cudaStream_t>(stream));
}

int sweep_warp_bwd_f32(const void* g, const void* sx, const void* sy,
                       void* dsrc, int B, int R, int W, int D, int H, int C,
                       void* stream) {
  return launch_bwd<float>(g, sx, sy, dsrc, B, R, W, D, H, C,
                           static_cast<cudaStream_t>(stream));
}

int sweep_warp_bwd_bf16(const void* g, const void* sx, const void* sy,
                        void* dsrc, int B, int R, int W, int D, int H, int C,
                        void* stream) {
  return launch_bwd<__nv_bfloat16>(g, sx, sy, dsrc, B, R, W, D, H, C,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
