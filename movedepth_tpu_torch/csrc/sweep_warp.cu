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
// TPU cannot gather; Hopper gathers natively. A point's C channels are L =
// C/V 16-byte chunks (V = 4 float32 or 8 bfloat16 channels) on L
// neighbouring lanes, so each tap is one 16-byte load a lane and a warp
// stores 32/L whole points of an output row. The block is (L lanes, 128/L
// pixels of one row h) and the grid (x-tiles, h, b): no index division.
// A thread walks all D planes of its (pixel, chunk), 2 planes at a time:
// the next 2 planes' coordinates are loaded before this pair's stores, so
// the HBM latency of the coordinate reads hides behind the gathers and
// stores. Where L is a power of two from 2 to 32, lane j of a point
// computes the taps (clamp, floor, weights, validity) of plane j of the
// pair and hands them to the other lanes by __shfl_sync, instead of every
// lane repeating them. The output, written once and read by the next op,
// is stored evict-first (__stcs).
//
// What bounds the forward: the 94 MB output at the train shape (B=12,
// D=16, H=R=48, W=160, C=32, bfloat16) and the gathers that feed it.
// Measured on an H100 SXM at 700 W: a zero fill of the output takes
// 0.032 ms (the bound of all the bytes is 0.0335 ms), the kernel's stores
// alone on its grid 0.038 ms, and taking the gathers out of the design a
// step before this one (4 planes a thread, no walk) saved 0.024 of its
// 0.070 ms. Each tap is a 16-byte load a lane, so the gathers move 4x the
// output's bytes through L1, where most hit (neighbouring pixels and
// planes share taps). 2 planes a thread keep the registers at 64 (32
// warps an SM); 4 planes (114 registers) lose at KITTI speed, 8 spill.
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

constexpr int kThreads = 256;  // backward block
constexpr int kAhead = 4;  // planes whose loads the backward issues together

// Forward: planes a thread handles at a time, and threads a block.
constexpr int kFwdPlanes = 2;
constexpr int kFwdThreads = 128;

// 16 raw bytes of T: 4 float32 or 8 bfloat16 values, unconverted.
__device__ __forceinline__ uint4 load_raw(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack(uint4 v, float* dst, float) {
  dst[0] = __uint_as_float(v.x);
  dst[1] = __uint_as_float(v.y);
  dst[2] = __uint_as_float(v.z);
  dst[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(uint4 v, float* dst, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// 16 bytes of T from floats, rounded once, stored evict-first.
__device__ __forceinline__ void store_cs(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store_cs(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// Coordinate slots of a thread: its kFwdPlanes planes (kL == 0), or the
// planes j, j + kL, ... whose taps lane j computes for the kL lanes of its
// point.
template <int kL>
__host__ __device__ constexpr int coord_slots() {
  return kL == 0 ? kFwdPlanes : (kFwdPlanes + kL - 1) / kL;
}

// The coordinates of planes d0 .. d0 + kFwdPlanes - 1 (the last plane
// standing in past D) at offset p0 of plane d0.
template <int kL>
__device__ __forceinline__ void load_coords(const float* __restrict__ sx,
                                            const float* __restrict__ sy,
                                            size_t p0, size_t hw, int d0,
                                            int D, int lane, float* xs,
                                            float* ys) {
#pragma unroll
  for (int r = 0; r < coord_slots<kL>(); ++r) {
    const int u = kL == 0 ? r : min(r * kL + lane, kFwdPlanes - 1);
    const size_t q = p0 + min(u, D - 1 - d0) * hw;
    xs[r] = sx[q];
    ys[r] = sy[q];
  }
}

// The tap weights and gathered source chunks of kFwdPlanes planes.
struct Gathered {
  float w[kFwdPlanes][4];
  uint4 v[kFwdPlanes][4];
};

// The planes' taps from their coordinates (kL > 0: computed by one lane
// each and handed round by shuffles), then every gather issued at once;
// taps outside the frame read nothing and hold zeros.
template <typename T, int kL>
__device__ __forceinline__ void gather(Gathered& g, const float* xs,
                                       const float* ys,
                                       const T* __restrict__ s, int W, int R,
                                       int C) {
  constexpr int N = coord_slots<kL>();
  int mx[N], my[N];
  float mw[N][4];
  unsigned mv[N];  // bit k: tap k inside the frame
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const mdt::Taps t = mdt::zeros_taps(xs[r], ys[r], W, R);
    mx[r] = t.x0;
    my[r] = t.y0;
    mv[r] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      mw[r][k] = t.w[k];
      mv[r] |= t.valid[k] ? 1u << k : 0u;
    }
  }
#pragma unroll
  for (int u = 0; u < kFwdPlanes; ++u) {
    int x0, y0;
    unsigned valid;
    if constexpr (kL == 0) {
      x0 = mx[u];
      y0 = my[u];
      valid = mv[u];
#pragma unroll
      for (int k = 0; k < 4; ++k) g.w[u][k] = mw[u][k];
    } else {
      const int r = u / kL, from = u % kL;
      x0 = __shfl_sync(0xffffffffu, mx[r], from, kL);
      y0 = __shfl_sync(0xffffffffu, my[r], from, kL);
      valid = __shfl_sync(0xffffffffu, mv[r], from, kL);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        g.w[u][k] = __shfl_sync(0xffffffffu, mw[r][k], from, kL);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long off =
          static_cast<long long>(y0 + (k >> 1)) * W + x0 + (k & 1);
      g.v[u][k] = (valid >> k) & 1u ? load_raw(s + off * C)
                                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The planes' weighted sums (float32 weights and sums, one rounding),
// stored for the planes below D.
template <typename T>
__device__ __forceinline__ void blend_store(const Gathered& g,
                                            T* __restrict__ o, size_t hwc,
                                            int d0, int D) {
  constexpr int V = mdt::Vec<T>::N;
#pragma unroll
  for (int u = 0; u < kFwdPlanes; ++u) {
    if (d0 + u >= D) break;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float f[V];
      unpack(g.v[u][k], f, T());
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(g.w[u][k], f[j], acc[j]);
    }
    store_cs(o + u * hwc, acc);
  }
}

// src (B,R,W,C) T, sx/sy (B,D,H,W) f32 -> out (B,D,H,W,C) T. Block
// (lanes, pixels): threadIdx.x a 16-byte chunk, threadIdx.y a pixel of the
// x-tile; grid (x-tiles, h, b), strided past 65535. Each thread walks the D
// planes of its (pixel, chunk). kL > 0: kL == C / V, and the kL lanes of a
// point share the tap arithmetic.
template <typename T, int kL>
__global__ void __launch_bounds__(kFwdThreads)
    sweep_warp_fwd_kernel(const T* __restrict__ src,
                          const float* __restrict__ sx,
                          const float* __restrict__ sy, T* __restrict__ out,
                          int B, int R, int W, int D, int H, int C) {
  constexpr int V = mdt::Vec<T>::N;
  constexpr int P = kFwdPlanes;
  const int L = C / V;
  const size_t hw = static_cast<size_t>(H) * W;
  const int x_ = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = x_ < W;
  const int x = live ? x_ : W - 1;  // dead pixels join the shuffles
  for (int b = blockIdx.z; b < B; b += gridDim.z)
    for (int h = blockIdx.y; h < H; h += gridDim.y) {
      const size_t p00 = static_cast<size_t>(b) * D * hw +
                         static_cast<size_t>(h) * W + x;  // plane 0
      for (int lane = threadIdx.x; lane < L; lane += blockDim.x) {
        const int c0 = lane * V;
        const T* __restrict__ s =
            src + static_cast<size_t>(b) * R * W * C + c0;
        float xs[coord_slots<kL>()], ys[coord_slots<kL>()];
        load_coords<kL>(sx, sy, p00, hw, 0, D, lane, xs, ys);
        for (int d0 = 0;; d0 += P) {
          Gathered g;
          gather<T, kL>(g, xs, ys, s, W, R, C);
          const bool more = d0 + P < D;
          if (more)
            load_coords<kL>(sx, sy, p00 + (d0 + P) * hw, hw, d0 + P, D, lane,
                            xs, ys);
          if (live)
            blend_store(g, out + (p00 + d0 * hw) * C + c0, hw * C, d0, D);
          if (!more) break;
        }
      }
    }
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

template <typename T, int kL>
int launch_fwd_lanes(const void* src, const void* sx, const void* sy,
                     void* out, int B, int R, int W, int D, int H, int C,
                     cudaStream_t stream) {
  const int lanes = min(C / mdt::Vec<T>::N, kFwdThreads);
  const int pixels = kFwdThreads / lanes;
  const dim3 block(lanes, pixels);
  const dim3 grid((W + pixels - 1) / pixels, min(H, 65535), min(B, 65535));
  sweep_warp_fwd_kernel<T, kL><<<grid, block, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const float*>(sx),
      static_cast<const float*>(sy), static_cast<T*>(out), B, R, W, D, H, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* src, const void* sx, const void* sy, void* out,
               int B, int R, int W, int D, int H, int C,
               cudaStream_t stream) {
  if (C <= 0 || C % mdt::Vec<T>::N) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * D * H * W == 0) return 0;
  // lanes of a point share its taps where they fill warp segments evenly
  switch (C / mdt::Vec<T>::N) {
#define FWD_LANES(l)                                                     \
  case l:                                                                \
    return launch_fwd_lanes<T, l>(src, sx, sy, out, B, R, W, D, H, C,   \
                                  stream);
    FWD_LANES(2) FWD_LANES(4) FWD_LANES(8) FWD_LANES(16) FWD_LANES(32)
#undef FWD_LANES
    default:
      return launch_fwd_lanes<T, 0>(src, sx, sy, out, B, R, W, D, H, C,
                                    stream);
  }
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
