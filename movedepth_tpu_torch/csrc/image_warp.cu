// Full-resolution photometric image warp, border mode: forward, the
// in-kernel photometric L1 epilogue and the coordinate gradient.
//
// Replaces the Pallas TPU kernels of movedepth_tpu/ops/pallas/image_warp.py:
//   * warp_images_border (forward, _warp_cw_call / _warp_cw_kernel):
//       out[b,k,y,x,:] = bilinear sample of src[b] at (sx, sy)[b,k,y,x]
//   * _warp_cw_l1_cdiff (the same kernel with a target, NC > 0): also
//       l1[b,k,y,x] = mean_c |out[b,k,y,x,c] - tgt[b,y,x,c]|
//     from the values the kernel just computed, so the warped stack is not
//     read back for the L1 tail.
//   * _coord_bwd_cw_call (the custom coordinate VJP, _coord_bwd_cw_kernel,
//     launched once for x and once for y on the TPU):
//       dsx = sum_c g_c * d out_c / d sx,  dsy likewise
//     Both components come from one launch here. With the L1 epilogue the
//     L1 cotangent folds into g as _warp_cw_l1_cdiff_bwd does:
//       g_c += sign(out_c - tgt_c) * g_l1 / C   (sign(0) = 0)
//     where out_c is recomputed from the four taps the backward reads
//     anyway: the warped stack is neither saved nor re-read.
//     The images and the target get no gradient: they are training data.
// Border mode is a clamp of the coordinates into [0, W-1] x [0, R-1],
// done by the caller (with a gradient of 1/2 at an exact bound, as JAX's
// clip has); the kernels clamp again only to keep indices in range. The
// taps follow the JAX package's gather path (ops/sampling.py::_sample_one):
// a tap past the last column or row reads 0. It has weight 0 in the
// forward pass, but it enters the coordinate derivative at x = W-1 and at
// y = R-1, and the kernel keeps it there.
//
// Design. The TPU kernels contract one-hot selection matrices on the MXU in
// a planar channel-in-sublane layout, with a bf16 hi/lo split of the
// images and row/column windows, because a TPU cannot gather. Hopper
// gathers natively: one thread per output pixel (b, k, y, x) reads its
// coordinates and the 4 taps of C float32 channels. No atomics: every
// thread writes only its own outputs. The sample is summed with explicit
// round-to-nearest operations in the plain version's order (no FMA
// contraction), so the backward's recomputed sample equals the forward's
// bit for bit and the sign of the L1 cotangent is the forward's.
//
// What bounds it: HBM traffic. At the shipped train shape (B=12, K=6,
// R=192, W=640, C=3) the forward writes 106 MB and reads 71 MB of
// coordinates; each 1.5 MB image is read K times, from L2. The L1 epilogue
// adds 35 MB of output and reads the 4.4 MB target K times (from L2). The
// backward reads the 106 MB gradient and the coordinates and writes 71 MB;
// with the L1 epilogue it also reads the 35 MB L1 gradient.

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;

struct BorderTaps {
  const float* p00;  // tap (y0, x0); the others are +1 column / +1 row
  float fx, fy;
  bool x1, y1;  // whether the +1 column / +1 row lies inside the image
};

__device__ __forceinline__ BorderTaps border_taps(const float* img, float x,
                                                  float y, int R, int W,
                                                  int C) {
  x = fminf(fmaxf(x, 0.0f), W - 1.0f);
  y = fminf(fmaxf(y, 0.0f), R - 1.0f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  BorderTaps t;
  t.p00 = img + (static_cast<long long>(y0) * W + x0) * C;
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.x1 = x0 + 1 < W;
  t.y1 = y0 + 1 < R;
  return t;
}

// The 4 tap values of channel c: v00, v01 (+1 column), v10 (+1 row), v11.
__device__ __forceinline__ void tap_values(const BorderTaps& t, int c, int W,
                                           int C, float* v) {
  const long long row = static_cast<long long>(W) * C;
  v[0] = t.p00[c];
  v[1] = t.x1 ? t.p00[C + c] : 0.0f;
  v[2] = t.y1 ? t.p00[row + c] : 0.0f;
  v[3] = (t.x1 && t.y1) ? t.p00[row + C + c] : 0.0f;
}

// The bilinear tap weights w00, w01, w10, w11, each one rounded product.
struct Weights {
  float w[4];
};

__device__ __forceinline__ Weights tap_weights(const BorderTaps& t) {
  const float gx = 1.0f - t.fx;
  const float gy = 1.0f - t.fy;
  return {{__fmul_rn(gx, gy), __fmul_rn(t.fx, gy), __fmul_rn(gx, t.fy),
           __fmul_rn(t.fx, t.fy)}};
}

// ((v00*w00 + v01*w01) + v10*w10) + v11*w11, every step rounded on its own.
__device__ __forceinline__ float border_sample(const float* v,
                                               const Weights& w) {
  float s = __fmul_rn(v[0], w.w[0]);
  s = __fadd_rn(s, __fmul_rn(v[1], w.w[1]));
  s = __fadd_rn(s, __fmul_rn(v[2], w.w[2]));
  return __fadd_rn(s, __fmul_rn(v[3], w.w[3]));
}

// src (B,R,W,C), sx/sy (B,K,R,W) -> out (B,K,R,W,C), all float32; with kL1
// also tgt (B,R,W,C) -> l1 (B,K,R,W).
template <bool kL1>
__global__ void __launch_bounds__(kThreads)
    warp_border_fwd_kernel(const float* __restrict__ src,
                           const float* __restrict__ tgt,
                           const float* __restrict__ sx,
                           const float* __restrict__ sy,
                           float* __restrict__ out, float* __restrict__ l1,
                           long long n, int R, int W, int KRW, int C) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const long long b = p / KRW;
  const long long RW = static_cast<long long>(R) * W;
  const BorderTaps t = border_taps(src + b * RW * C, sx[p], sy[p], R, W, C);
  const Weights w = tap_weights(t);
  const float* tp = kL1 ? tgt + (b * RW + p % RW) * C : nullptr;
  float dsum = 0.0f;
  for (int c = 0; c < C; ++c) {
    float v[4];
    tap_values(t, c, W, C, v);
    const float s = border_sample(v, w);
    out[p * C + c] = s;
    if (kL1) dsum = __fadd_rn(dsum, fabsf(__fsub_rn(s, tp[c])));
  }
  // true division, as the TPU kernel's epilogue and jnp.mean divide
  if (kL1) l1[p] = __fdiv_rn(dsum, static_cast<float>(C));
}

// g (B,K,R,W,C) -> dsx, dsy (B,K,R,W): the derivative of the bilinear
// sample with respect to the (clamped) coordinates, summed over channels.
// With kL1, g_c gains sign(sample_c - tgt_c) * gl1 / C first.
template <bool kL1>
__global__ void __launch_bounds__(kThreads)
    warp_border_bwd_kernel(const float* __restrict__ src,
                           const float* __restrict__ tgt,
                           const float* __restrict__ sx,
                           const float* __restrict__ sy,
                           const float* __restrict__ g,
                           const float* __restrict__ gl1,
                           float* __restrict__ dsx, float* __restrict__ dsy,
                           long long n, int R, int W, int KRW, int C) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const long long b = p / KRW;
  const long long RW = static_cast<long long>(R) * W;
  const BorderTaps t = border_taps(src + b * RW * C, sx[p], sy[p], R, W, C);
  Weights w;
  const float* tp = nullptr;
  float gl = 0.0f;
  if (kL1) {
    w = tap_weights(t);
    tp = tgt + (b * RW + p % RW) * C;
    gl = __fdiv_rn(gl1[p], static_cast<float>(C));
  }
  float gx = 0.0f;
  float gy = 0.0f;
  for (int c = 0; c < C; ++c) {
    float v[4];
    tap_values(t, c, W, C, v);
    float gc = g[p * C + c];
    if (kL1) {
      const float d = __fsub_rn(border_sample(v, w), tp[c]);
      const float sgn = static_cast<float>((d > 0.0f) - (d < 0.0f));
      gc = __fadd_rn(gc, __fmul_rn(sgn, gl));
    }
    gx = fmaf(gc, (1.0f - t.fy) * (v[1] - v[0]) + t.fy * (v[3] - v[2]), gx);
    gy = fmaf(gc, (1.0f - t.fx) * (v[2] - v[0]) + t.fx * (v[3] - v[1]), gy);
  }
  dsx[p] = gx;
  dsy[p] = gy;
}

dim3 grid_for(long long n) {
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" {

int warp_images_border_fwd(const void* src, const void* sx, const void* sy,
                           void* out, int B, int R, int W, int K, int C,
                           void* stream) {
  const long long n = static_cast<long long>(B) * K * R * W;
  if (n == 0 || C == 0) return 0;
  warp_border_fwd_kernel<false>
      <<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(src), nullptr,
          static_cast<const float*>(sx), static_cast<const float*>(sy),
          static_cast<float*>(out), nullptr, n, R, W, K * R * W, C);
  return static_cast<int>(cudaGetLastError());
}

int warp_images_border_bwd(const void* src, const void* sx, const void* sy,
                           const void* g, void* dsx, void* dsy, int B, int R,
                           int W, int K, int C, void* stream) {
  const long long n = static_cast<long long>(B) * K * R * W;
  if (n == 0) return 0;
  warp_border_bwd_kernel<false>
      <<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(src), nullptr,
          static_cast<const float*>(sx), static_cast<const float*>(sy),
          static_cast<const float*>(g), nullptr, static_cast<float*>(dsx),
          static_cast<float*>(dsy), n, R, W, K * R * W, C);
  return static_cast<int>(cudaGetLastError());
}

int warp_images_border_l1_fwd(const void* src, const void* tgt,
                              const void* sx, const void* sy, void* out,
                              void* l1, int B, int R, int W, int K, int C,
                              void* stream) {
  const long long n = static_cast<long long>(B) * K * R * W;
  if (n == 0 || C == 0) return 0;
  warp_border_fwd_kernel<true>
      <<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(src), static_cast<const float*>(tgt),
          static_cast<const float*>(sx), static_cast<const float*>(sy),
          static_cast<float*>(out), static_cast<float*>(l1), n, R, W,
          K * R * W, C);
  return static_cast<int>(cudaGetLastError());
}

int warp_images_border_l1_bwd(const void* src, const void* tgt,
                              const void* sx, const void* sy, const void* g,
                              const void* gl1, void* dsx, void* dsy, int B,
                              int R, int W, int K, int C, void* stream) {
  const long long n = static_cast<long long>(B) * K * R * W;
  if (n == 0 || C == 0) return 0;
  warp_border_bwd_kernel<true>
      <<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(src), static_cast<const float*>(tgt),
          static_cast<const float*>(sx), static_cast<const float*>(sy),
          static_cast<const float*>(g), static_cast<const float*>(gl1),
          static_cast<float*>(dsx), static_cast<float*>(dsy), n, R, W,
          K * R * W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
