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
// the depth bins (which would remove the coordinate reads). The kernel
// itself is in sweep_warp_corr.cuh, shared with the stage ablations of
// sweep_warp_corr_variants.cu.

#include "sweep_warp_corr.cuh"

namespace {

using mdt_swc::kThreads;
using mdt_swc::sweep_warp_corr_kernel;

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
