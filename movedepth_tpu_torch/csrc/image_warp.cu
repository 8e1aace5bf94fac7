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
// Border mode is a clamp of the coordinates into [0, W-1] x [0, R-1]. The
// kernels take the raw coordinates and clamp in registers; the backward
// multiplies each component by the clamp's derivative (1 inside, 1/2 on an
// exact bound, as JAX's clip has, 1/4 where 0 = W-1 or 0 = R-1, 0
// outside). The taps follow the JAX package's gather path
// (ops/sampling.py::_sample_one): a tap past the last column or row reads
// 0. It has weight 0 in the forward pass, but it enters the coordinate
// derivative at x = W-1 and at y = R-1, and the kernel keeps it there.
//
// Layouts, all float32: images and target (B, R, W, C); coordinates sx, sy
// and the L1 map (B, K, R, W); the warped stack and its gradient
// (B, K, R, W, C).
//
// What bounds it: HBM bytes. At the shipped train shape (B=12, K=6, R=192,
// W=640, C=3) the forward writes the 106 MB stack and reads 71 MB of
// coordinates; the images (17.7 MB) are read K times, from L2. The L1
// epilogue adds 35 MB of output and reads the 17.7 MB target. The backward
// reads the 106 MB gradient and the coordinates and writes 71 MB; with the
// L1 epilogue it also reads the 35 MB L1 gradient. About 40 float32
// operations a pixel are far below the card's rate.
//
// Design. The TPU kernels contract one-hot selection matrices on the MXU in
// a planar layout, with a bf16 hi/lo split and row/column windows, because
// a TPU cannot gather; Hopper gathers natively, so none of that is kept. A
// grid of (R*W / (4*256), K, B) blocks: b and k come from blockIdx, offsets
// inside one (R, W) plane (R*W < 2^31 pixels) are 32-bit, and no thread
// divides. Each thread covers 4 consecutive pixels of one map:
// coordinates, the L1 map, its gradient and dsx, dsy move one float4 each,
// and the 12 floats of 4 RGB pixels (stack, its gradient, the target)
// three. The 12 taps of a pixel are scalar loads through the read-only
// path; the images (17.7 MB) stay in L2. PERF.md keeps the times of the
// design steps that led here and of the ones left out (one thread over all
// K maps, images repacked to float4 taps, evict-first hints, the RGB
// stream staged through shared memory). A plane whose R*W is not a
// multiple of 4, or a stream whose base is not 16-byte aligned, takes the
// pixel-by-pixel path of the same kernel; C other than 3 a per-channel
// loop. No atomics: every thread writes only its own outputs. The sample
// is summed with explicit round-to-nearest operations in the plain
// version's order (no FMA contraction), so the forward equals the plain
// version bit for bit and the backward's recomputed sample equals the
// forward's, which keeps the sign of the L1 cotangent exact. Registers a
// thread (ptxas, C = 3): 35 forward, 40 with the L1 epilogue, 40 backward,
// 74 with it; no spills.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;  // consecutive pixels of one plane a thread covers

// The border clamp's derivative, as torch.minimum(torch.maximum(v, 0), hi)
// and jnp.clip give it under autodiff: 1 inside (0, hi), 1/2 on one exact
// bound, 1/4 where v = 0 = hi (a 1-pixel-wide or -tall image), 0 outside.
__device__ __forceinline__ float clamp_slope(float v, float hi) {
  const float lo_part = v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
  const float hi_part = v < hi ? 1.0f : (v == hi ? 0.5f : 0.0f);
  return lo_part * hi_part;
}

// Tap (y0, x0) of a sample at (x, y) clamped into the frame; the taps
// +1 column and +1 row read 0 past the last column / row.
struct Tap {
  int o;  // pixel offset y0 * W + x0 in the image
  float fx, fy;
  bool x1, y1;  // whether the +1 column / +1 row lies inside the image
};

__device__ __forceinline__ Tap border_tap(float x, float y, int R, int W) {
  x = fminf(fmaxf(x, 0.0f), W - 1.0f);
  y = fminf(fmaxf(y, 0.0f), R - 1.0f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  Tap t;
  t.o = y0 * W + x0;
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.x1 = x0 + 1 < W;
  t.y1 = y0 + 1 < R;
  return t;
}

// The bilinear tap weights w00, w01, w10, w11, each one rounded product.
struct Weights {
  float w[4];
};

__device__ __forceinline__ Weights tap_weights(const Tap& t) {
  const float gx = 1.0f - t.fx;
  const float gy = 1.0f - t.fy;
  return {{__fmul_rn(gx, gy), __fmul_rn(t.fx, gy), __fmul_rn(gx, t.fy),
           __fmul_rn(t.fx, t.fy)}};
}

// ((v00*w00 + v01*w01) + v10*w10) + v11*w11, every step rounded on its own:
// the plain version's order, so the sample equals it bit for bit.
__device__ __forceinline__ float border_sample(const float* v,
                                               const Weights& w) {
  float s = __fmul_rn(v[0], w.w[0]);
  s = __fadd_rn(s, __fmul_rn(v[1], w.w[1]));
  s = __fadd_rn(s, __fmul_rn(v[2], w.w[2]));
  return __fadd_rn(s, __fmul_rn(v[3], w.w[3]));
}

// The four taps of channel c of one sample, read from the (R, W, C) image
// through the read-only path: v00, v01 (+1 column), v10 (+1 row), v11.
__device__ __forceinline__ void tap_values(const float* img, const Tap& t,
                                           int W, int C, int c, float* v) {
  const float* p = img + t.o * C + c;
  const int row = W * C;
  v[0] = __ldg(p);
  v[1] = t.x1 ? __ldg(p + C) : 0.0f;
  v[2] = t.y1 ? __ldg(p + row) : 0.0f;
  v[3] = (t.x1 && t.y1) ? __ldg(p + row + C) : 0.0f;
}

// Sample every channel of img at (x, y); emit(c, value) takes each.
template <int kC, class Emit>
__device__ __forceinline__ void sample_pixel(const float* img, float x,
                                             float y, int R, int W, int C,
                                             Emit emit) {
  const Tap t = border_tap(x, y, R, W);
  const Weights w = tap_weights(t);
#pragma unroll
  for (int c = 0; c < (kC > 0 ? kC : C); ++c) {
    float v[4];
    tap_values(img, t, W, C, c, v);
    emit(c, border_sample(v, w));
  }
}

// d sample / d (x, y) summed over channels with weights g(c), times the
// clamp's derivative. With kL1, g(c) first gains sign(sample_c - tgt(c)) *
// gl, the sample recomputed from the taps bit for bit as the forward's.
template <bool kL1, int kC, class G, class Tgt>
__device__ __forceinline__ void coord_grad_pixel(const float* img, float x,
                                                 float y, int R, int W,
                                                 int C, G g, Tgt tgt,
                                                 float gl, float& dx,
                                                 float& dy) {
  const Tap t = border_tap(x, y, R, W);
  Weights w;
  if (kL1) w = tap_weights(t);
  float gx = 0.0f;
  float gy = 0.0f;
#pragma unroll
  for (int c = 0; c < (kC > 0 ? kC : C); ++c) {
    float v[4];
    tap_values(img, t, W, C, c, v);
    float gc = g(c);
    if (kL1) {
      const float d = __fsub_rn(border_sample(v, w), tgt(c));
      const float sgn = static_cast<float>((d > 0.0f) - (d < 0.0f));
      gc = __fadd_rn(gc, __fmul_rn(sgn, gl));
    }
    gx = fmaf(gc, (1.0f - t.fy) * (v[1] - v[0]) + t.fy * (v[3] - v[2]), gx);
    gy = fmaf(gc, (1.0f - t.fx) * (v[2] - v[0]) + t.fx * (v[3] - v[1]), gy);
  }
  dx = gx * clamp_slope(x, W - 1.0f);
  dy = gy * clamp_slope(y, R - 1.0f);
}

// 4 floats of a stream as one 16-byte access.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The kC float4s from p (kC*4 floats) into o.
template <int kC>
__device__ __forceinline__ void ld4s(const float* p, float* o) {
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + j);
    o[4 * j] = v.x;
    o[4 * j + 1] = v.y;
    o[4 * j + 2] = v.z;
    o[4 * j + 3] = v.w;
  }
}

// src (B,R,W,C), sx/sy (B,K,R,W) -> out (B,K,R,W,C); with kL1 also tgt
// (B,R,W,C) -> l1 (B,K,R,W) = mean_c |out - tgt|. kC fixes the channels at
// compile time and takes 16-byte accesses where `aligned` and R*W allow;
// kC = 0 reads C from the call and goes pixel by pixel.
template <bool kL1, int kC>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
               const float* __restrict__ sx, const float* __restrict__ sy,
               float* __restrict__ out, float* __restrict__ l1, int R, int W,
               int K, int C, bool aligned) {
  const int RW = R * W;
  const int q = (blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (q >= RW) return;
  const int b = blockIdx.z;
  const int cs = kC > 0 ? kC : C;
  const float* img = src + static_cast<size_t>(b) * RW * cs;
  const float* tp = kL1 ? tgt + (static_cast<size_t>(b) * RW + q) * cs
                        : nullptr;
  const size_t p = (static_cast<size_t>(b) * K + blockIdx.y) * RW + q;
  if constexpr (kC > 0) {
    if (aligned && RW % 4 == 0) {
      float tv[4 * kC];  // the target of the 4 pixels
      if (kL1) ld4s<kC>(tp, tv);
      float o[4 * kC];
      const float4 X = ld4(sx + p);
      const float4 Y = ld4(sy + p);
      const float xs[4] = {X.x, X.y, X.z, X.w};
      const float ys[4] = {Y.x, Y.y, Y.z, Y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sample_pixel<kC>(img, xs[i], ys[i], R, W, kC,
                         [&](int c, float s) { o[i * kC + c] = s; });
      float* op = out + p * kC;
#pragma unroll
      for (int j = 0; j < kC; ++j)
        st4(op + 4 * j, o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
      if (kL1) {
        float m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float dsum = 0.0f;
#pragma unroll
          for (int c = 0; c < kC; ++c)
            dsum = __fadd_rn(dsum,
                             fabsf(__fsub_rn(o[i * kC + c], tv[i * kC + c])));
          // true division, as the TPU kernel's epilogue and jnp.mean do
          m[i] = __fdiv_rn(dsum, static_cast<float>(kC));
        }
        st4(l1 + p, m[0], m[1], m[2], m[3]);
      }
      return;
    }
  }
  const int n = min(kPix, RW - q);
  for (int i = 0; i < n; ++i) {
    float* op = out + (p + i) * cs;
    const float* ti = kL1 ? tp + i * cs : nullptr;
    float dsum = 0.0f;
    sample_pixel<kC>(img, sx[p + i], sy[p + i], R, W, cs,
                     [&](int c, float s) {
                       op[c] = s;
                       if (kL1)
                         dsum = __fadd_rn(dsum, fabsf(__fsub_rn(s, ti[c])));
                     });
    if (kL1) l1[p + i] = __fdiv_rn(dsum, static_cast<float>(cs));
  }
}

// g (B,K,R,W,C) [+ gl1 (B,K,R,W) and tgt (B,R,W,C) with kL1] -> dsx, dsy
// (B,K,R,W): the coordinate gradient of the forward, border clamp included.
template <bool kL1, int kC>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
               const float* __restrict__ sx, const float* __restrict__ sy,
               const float* __restrict__ g, const float* __restrict__ gl1,
               float* __restrict__ dsx, float* __restrict__ dsy, int R, int W,
               int K, int C, bool aligned) {
  const int RW = R * W;
  const int q = (blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (q >= RW) return;
  const int b = blockIdx.z;
  const int cs = kC > 0 ? kC : C;
  const float* img = src + static_cast<size_t>(b) * RW * cs;
  const float* tp = kL1 ? tgt + (static_cast<size_t>(b) * RW + q) * cs
                        : nullptr;
  const size_t p = (static_cast<size_t>(b) * K + blockIdx.y) * RW + q;
  const float cf = static_cast<float>(cs);
  if constexpr (kC > 0) {
    if (aligned && RW % 4 == 0) {
      float tv[4 * kC];
      if (kL1) ld4s<kC>(tp, tv);
      float gv[4 * kC];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float4 g4 = ld4(g + p * kC + 4 * j);
        gv[4 * j] = g4.x;
        gv[4 * j + 1] = g4.y;
        gv[4 * j + 2] = g4.z;
        gv[4 * j + 3] = g4.w;
      }
      const float4 X = ld4(sx + p);
      const float4 Y = ld4(sy + p);
      const float xs[4] = {X.x, X.y, X.z, X.w};
      const float ys[4] = {Y.x, Y.y, Y.z, Y.w};
      float gls[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kL1) {
        const float4 G = ld4(gl1 + p);
        gls[0] = __fdiv_rn(G.x, cf);
        gls[1] = __fdiv_rn(G.y, cf);
        gls[2] = __fdiv_rn(G.z, cf);
        gls[3] = __fdiv_rn(G.w, cf);
      }
      float dx[4], dy[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        coord_grad_pixel<kL1, kC>(
            img, xs[i], ys[i], R, W, kC,
            [&](int c) { return gv[i * kC + c]; },
            [&](int c) { return tv[i * kC + c]; }, gls[i], dx[i], dy[i]);
      st4(dsx + p, dx[0], dx[1], dx[2], dx[3]);
      st4(dsy + p, dy[0], dy[1], dy[2], dy[3]);
      return;
    }
  }
  const int n = min(kPix, RW - q);
  for (int i = 0; i < n; ++i) {
    const float* gi = g + (p + i) * cs;
    const float* ti = kL1 ? tp + i * cs : nullptr;
    const float gl = kL1 ? __fdiv_rn(gl1[p + i], cf) : 0.0f;
    float dx, dy;
    coord_grad_pixel<kL1, kC>(
        img, sx[p + i], sy[p + i], R, W, cs, [&](int c) { return gi[c]; },
        [&](int c) { return ti[c]; }, gl, dx, dy);
    dsx[p + i] = dx;
    dsy[p + i] = dy;
  }
}

dim3 grid_of(int B, int R, int W, int K) {
  const int per_block = kThreads * kPix;
  return dim3(static_cast<unsigned>(
                  (static_cast<long long>(R) * W + per_block - 1) / per_block),
              K, B);
}

// C = 3, the shipped images, has its own instantiation; other C loop over
// the channels.
template <bool kL1>
int fwd(const void* src, const void* tgt, const void* sx, const void* sy,
        void* out, void* l1, int B, int R, int W, int K, int C, int aligned,
        void* stream) {
  if (static_cast<long long>(B) * K * R * W == 0 || C == 0) return 0;
  auto kernel = C == 3 ? fwd_kernel<kL1, 3> : fwd_kernel<kL1, 0>;
  kernel<<<grid_of(B, R, W, K), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const float*>(sx), static_cast<const float*>(sy),
      static_cast<float*>(out), static_cast<float*>(l1), R, W, K, C,
      aligned != 0);
  return static_cast<int>(cudaGetLastError());
}

template <bool kL1>
int bwd(const void* src, const void* tgt, const void* sx, const void* sy,
        const void* g, const void* gl1, void* dsx, void* dsy, int B, int R,
        int W, int K, int C, int aligned, void* stream) {
  if (static_cast<long long>(B) * K * R * W == 0) return 0;
  auto kernel = C == 3 ? bwd_kernel<kL1, 3> : bwd_kernel<kL1, 0>;
  kernel<<<grid_of(B, R, W, K), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const float*>(sx), static_cast<const float*>(sy),
      static_cast<const float*>(g), static_cast<const float*>(gl1),
      static_cast<float*>(dsx), static_cast<float*>(dsy), R, W, K, C,
      aligned != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `aligned` is nonzero when every pointer the kernels move in 16-byte
// pieces (all but the images, which are read tap by tap) is 16-byte
// aligned; the kernels take 16-byte accesses only then (and where R*W is a
// multiple of 4).
extern "C" {

int warp_images_border_fwd(const void* src, const void* sx, const void* sy,
                           void* out, int B, int R, int W, int K, int C,
                           int aligned, void* stream) {
  return fwd<false>(src, nullptr, sx, sy, out, nullptr, B, R, W, K, C,
                    aligned, stream);
}

int warp_images_border_bwd(const void* src, const void* sx, const void* sy,
                           const void* g, void* dsx, void* dsy, int B, int R,
                           int W, int K, int C, int aligned, void* stream) {
  return bwd<false>(src, nullptr, sx, sy, g, nullptr, dsx, dsy, B, R, W, K,
                    C, aligned, stream);
}

int warp_images_border_l1_fwd(const void* src, const void* tgt,
                              const void* sx, const void* sy, void* out,
                              void* l1, int B, int R, int W, int K, int C,
                              int aligned, void* stream) {
  return fwd<true>(src, tgt, sx, sy, out, l1, B, R, W, K, C, aligned,
                   stream);
}

int warp_images_border_l1_bwd(const void* src, const void* tgt,
                              const void* sx, const void* sy, const void* g,
                              const void* gl1, void* dsx, void* dsy, int B,
                              int R, int W, int K, int C, int aligned,
                              void* stream) {
  return bwd<true>(src, tgt, sx, sy, g, gl1, dsx, dsy, B, R, W, K, C,
                   aligned, stream);
}

}  // extern "C"
