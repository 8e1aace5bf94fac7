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
// Forward. The TPU kernels express the gather as one-hot matmuls because a
// TPU cannot gather; Hopper gathers natively. One thread owns one 16-byte
// channel chunk (4 float32 or 8 bfloat16 channels) of one output point
// (b, d, h, x): neighbouring threads hold neighbouring chunks and then
// neighbouring x, so the coordinate reads, the tap reads and the output
// rows are coalesced. Bound: HBM traffic, the 94 MB output at the train
// shape (B=12, D=16, H=R=48, W=160, C=32, bfloat16).
//
// Source gradient. The TPU kernel keeps a batch element's whole dsrc in
// VMEM and adds to it grid step by grid step; a GPU has no such memory
// for 12 batch elements, so the transposed warp scatters with atomics. One
// thread owns a 16-byte channel chunk of one reference pixel (b, h, x) and
// walks its D planes. Neighbouring planes of a pixel often sample the
// same four source pixels (the epipolar segment moves by less than a pixel
// a plane at KITTI motion), so the thread sums w_tap * g in registers
// while the tap base (x0, y0) stays the same and adds the run to dsrc
// once, with 16-byte float4 atomicAdd (sm_90) into the zeroed float32
// (B,R,W,C) buffer that the wrapper allocates and casts afterwards. The
// loads of 4 planes (coordinates and gradient) are issued together, so a
// thread waits for memory once per 4 planes, not once a plane. The
// summation order, and so the last bits of dsrc, vary from run to run.
//
// What bounds the source gradient: the rate at which the L2 takes the
// float4 reductions, not HBM (the bound is the 94 MB gradient read once,
// 0.028 ms at 3.35 TB/s). Without the run-merge a point costs 4 taps x
// C/4 float4 reductions (47 M at the train shape); the merge cuts them by
// the run length, which shrinks as the motion between frames grows.
// Thread-block clusters that hold dsrc in shared memory (distributed
// shared memory for other CTAs' rows, halo rows, native red.shared adds)
// were measured slower at every setting: shared-memory float adds under
// this contention run far below the L2's float4 reductions.

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;  // planes whose loads the backward issues together

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

// g (B,D,H,W,C) T, sx/sy (B,D,H,W) f32 -> dsrc (B,R,W,C) f32 (pre-zeroed);
// one thread a (b, h, x, 16-byte chunk), over the D planes, kAhead planes'
// coordinates and gradient loaded at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sweep_warp_bwd_kernel(const T* __restrict__ g,
                          const float* __restrict__ sx,
                          const float* __restrict__ sy,
                          float* __restrict__ dsrc, long long n, int R, int W,
                          int D, int H, int C) {
  constexpr int V = mdt::Vec<T>::N;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int chunks = C / V;
  const long long pix = i / chunks;  // (b*H + h)*W + x
  const int c0 = static_cast<int>(i % chunks) * V;
  const int x = static_cast<int>(pix % W);
  const long long bh = pix / W;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  float* __restrict__ dst = dsrc + b * R * W * C + c0;
  float acc[4][V];  // the run's sums at the taps of base (bx, by)
  int bx = 0, by = -100;  // no run yet (a clamped y0 is at least -2)
  auto flush = [&]() {
    const bool vx0 = bx >= 0 && bx < W, vx1 = bx + 1 >= 0 && bx + 1 < W;
    const bool vy0 = by >= 0 && by < R, vy1 = by + 1 >= 0 && by + 1 < R;
    const bool valid[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!valid[k]) continue;
      float* q = dst + (static_cast<long long>(by + (k >> 1)) * W + bx +
                        (k & 1)) * C;
#pragma unroll
      for (int j = 0; j < V; j += 4)
        atomicAdd(reinterpret_cast<float4*>(q + j),
                  make_float4(acc[k][j], acc[k][j + 1], acc[k][j + 2],
                              acc[k][j + 3]));
    }
  };
  for (int d0 = 0; d0 < D; d0 += kAhead) {
    // every load of the next kAhead planes in flight at once (the last
    // plane's address stands in past D)
    float xs[kAhead], ys[kAhead], gv[kAhead][V];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long p = ((b * D + min(d0 + u, D - 1)) * H + h) * W + x;
      xs[u] = sx[p];
      ys[u] = sy[p];
      mdt::load16(g + p * C + c0, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (d0 + u >= D) break;
      const mdt::Taps t = mdt::zeros_taps(xs[u], ys[u], W, R);
      if (t.x0 != bx || t.y0 != by) {
        if (by != -100) flush();
        bx = t.x0;
        by = t.y0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < V; ++j) acc[k][j] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[k][j] = fmaf(t.w[k], gv[u][j], acc[k][j]);
    }
  }
  if (by != -100) flush();
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
  const long long n = static_cast<long long>(B) * H * W * (C / mdt::Vec<T>::N);
  if (n == 0 || D == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  sweep_warp_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const float*>(sx),
      static_cast<const float*>(sy), static_cast<float*>(dsrc), n, R, W, D, H,
      C);
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
