// Stage ablations of the plane-sweep warp-correlate kernel, for timing only.
//
// Replaces the Pallas TPU profiling kernels of
// scripts/profile_kernel_variants.py (run_variant -> pallas_call, body
// _variant_body), which take one stage of the TPU kernel out at a time (the
// one-hot H build, the MXU matmul, the V build, the product and reduce).
// Those stages do not exist on the card. This file takes out the CUDA
// kernel's own stages instead (sweep_warp_corr.cuh, mdt_swc::Skip):
//   0 full          the shipped kernel, bit for bit
//   1 no_gather     every tap reads one fixed address
//   2 no_weights    constant tap weights
//   4 no_correlate  no product with ref (ref is not read)
//   8 no_reduce     no shuffle between the lanes of a point: each lane
//                   stores its own partial group sums
// Every variant but full computes wrong results by design. They are built
// for the shipped inference shape only: C = 32 channels, G = 16 groups,
// bfloat16 features.
//
// What bounds them: as sweep_warp_corr.cu, HBM traffic (the 503 MB output
// at B=128 and the 126 MB of coordinates); the differences between the
// variants show what each stage adds on top.


#include "sweep_warp_corr.cuh"

namespace {

using mdt_swc::grid_blocks;
using mdt_swc::kThreads;
using mdt_swc::sweep_warp_corr_kernel;

constexpr int kC = 32;
constexpr int kG = 16;

template <int kSkip>
int launch(const void* src, const void* ref, const void* sx, const void* sy,
           void* out, int B, int R, int W, int D, int H,
           cudaStream_t stream) {
  if (static_cast<long long>(B) * H * W == 0 || D == 0) return 0;
  sweep_warp_corr_kernel<__nv_bfloat16, kC, kG, kSkip>
      <<<grid_blocks<__nv_bfloat16, kC>(B, H, W, D), kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(src),
          static_cast<const __nv_bfloat16*>(ref),
          static_cast<const float*>(sx), static_cast<const float*>(sy),
          static_cast<__nv_bfloat16*>(out), B, R, W, D, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// skip: one of 0, 1, 2, 4, 8 (see above); C and G must be 32 and 16.
int sweep_warp_corr_variant_bf16(int skip, const void* src, const void* ref,
                                 const void* sx, const void* sy, void* out,
                                 int B, int R, int W, int D, int H, int C,
                                 int G, void* stream) {
  if (C != kC || G != kG) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (skip) {
    case 0:
      return launch<0>(src, ref, sx, sy, out, B, R, W, D, H, s);
    case mdt_swc::kNoGather:
      return launch<mdt_swc::kNoGather>(src, ref, sx, sy, out, B, R, W, D, H,
                                        s);
    case mdt_swc::kNoWeights:
      return launch<mdt_swc::kNoWeights>(src, ref, sx, sy, out, B, R, W, D,
                                         H, s);
    case mdt_swc::kNoCorrelate:
      return launch<mdt_swc::kNoCorrelate>(src, ref, sx, sy, out, B, R, W, D,
                                           H, s);
    case mdt_swc::kNoReduce:
      return launch<mdt_swc::kNoReduce>(src, ref, sx, sy, out, B, R, W, D, H,
                                        s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
