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
// natively, so this is a plain gather kernel. The channels of a point are
// split over lanes: each lane owns one 16-byte chunk (8 bfloat16 or 4
// float32 channels), so a point takes L = C/V lanes (4 at C=32 in bf16) and
// each tap is one 16-byte load a lane. The lane correlates its chunk with
// the same chunk of ref (read once into registers, reused over the
// thread's planes). Group g averages channels k*G+g, so the lanes whose
// chunks hold the same groups add with __shfl_xor_sync; the first G/V
// lanes then store the point's G outputs as coalesced 16-byte rows (for
// G < V the reduction first runs inside the lane, and lane 0 stores). A
// thread walks 8 planes of one pixel; the grid covers (pixel tile, plane
// group), plane groups of one tile on neighbouring blocks, so they run
// together and share the tile's ref chunks and source taps in L2.
// Registers stay at 48-58 (one chunk each of taps, sums and ref), and
// batch 1 (7,680 pixels) still launches L threads a pixel for each 8
// planes.
//
// What bounds it: HBM traffic. At the shipped B=128, D=16, H=R=48, W=160,
// C=32, G=16 in bf16 it writes 128*16*48*160*16*2 B = 503 MB and reads 126
// MB of f32 coordinates and 126 MB of features; the 4 taps re-read the
// source features D times, mostly from L1 and L2 because neighbouring
// points share taps. The arithmetic is ~5*C FMAs per point. The kernel
// reaches ~40% of that bound: taking out the gather, the weights, the
// correlate or the shuffle (sweep_warp_corr_variants.cu) saves 4-10%
// each, so no single stage holds it; the L = 4 lanes of a point each
// repeat the coordinate reads and the tap arithmetic. No wgmma and
// no TMA: there is no matrix product here. Staging a source window with
// TMA, writing Reg3D's layout directly and computing sx/sy in-kernel from
// the depth bins (which would remove the coordinate reads) are left for
// later. The kernel itself is in sweep_warp_corr.cuh, shared with the
// stage ablations of sweep_warp_corr_variants.cu.

// Build: nvcc compiles this file once per C of the FPN's widths with
// -DSWC_C=<C> (that C's (C, G) instantiations) and once without (the C
// interface), in parallel, and links the units into one library
// (native.UNITS).

#include "sweep_warp_corr.cuh"

// The (C, G) pairs compiled in: every pair the JAX package fuses at the
// FPN's matching widths (8, 16, 32, 64 channels at prior scales 0-3):
// G divides C and C/G is a power of two. G < V (1 and 2; 4 in bfloat16)
// sums inside the lane and lane 0 stores; G = C needs no shuffle.
#define SWC_PAIRS(X)                                                     \
  X(8, 1) X(8, 2) X(8, 4) X(8, 8) X(16, 1) X(16, 2) X(16, 4) X(16, 8)    \
      X(16, 16) X(32, 1) X(32, 2) X(32, 4) X(32, 8) X(32, 16) X(32, 32)  \
      X(64, 1) X(64, 2) X(64, 4) X(64, 8) X(64, 16) X(64, 32) X(64, 64)

namespace mdt_swc {

// The kernel of the pair (C, G) in T (bfloat16 if bf16, else float32);
// cudaErrorInvalidValue if the pair is not built. Defined, for one C, in
// the unit compiled with -DSWC_C=C.
template <int C>
int launch_c(bool bf16, const void* src, const void* ref, const void* sx,
             const void* sy, void* out, int B, int R, int W, int D, int H,
             int G, cudaStream_t stream);

#ifdef SWC_C

template <typename T, int C, int G>
int launch_pair(const void* src, const void* ref, const void* sx,
                const void* sy, void* out, int B, int R, int W, int D, int H,
                cudaStream_t stream) {
  sweep_warp_corr_kernel<T, C, G>
      <<<grid_blocks<T, C>(B, H, W, D), kThreads, 0, stream>>>(
          static_cast<const T*>(src), static_cast<const T*>(ref),
          static_cast<const float*>(sx), static_cast<const float*>(sy),
          static_cast<T*>(out), B, R, W, D, H);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_c(bool bf16, const void* src, const void* ref, const void* sx,
             const void* sy, void* out, int B, int R, int W, int D, int H,
             int G, cudaStream_t stream) {
#define SWC_CASE(c, g)                                                      \
  if constexpr (c == C) {                                                   \
    if (G == g)                                                             \
      return bf16 ? launch_pair<__nv_bfloat16, c, g>(src, ref, sx, sy, out, \
                                                     B, R, W, D, H, stream) \
                  : launch_pair<float, c, g>(src, ref, sx, sy, out, B, R,   \
                                             W, D, H, stream);              \
  }
  SWC_PAIRS(SWC_CASE)
#undef SWC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template int launch_c<SWC_C>(bool, const void*, const void*, const void*,
                             const void*, void*, int, int, int, int, int, int,
                             cudaStream_t);

#endif  // SWC_C

}  // namespace mdt_swc

#ifndef SWC_C

namespace {

int launch(bool bf16, const void* src, const void* ref, const void* sx,
           const void* sy, void* out, int B, int R, int W, int D, int H,
           int C, int G, cudaStream_t stream) {
  if (static_cast<long long>(B) * H * W == 0 || D == 0) return 0;
  switch (C) {
    case 8:
      return mdt_swc::launch_c<8>(bf16, src, ref, sx, sy, out, B, R, W, D, H,
                                  G, stream);
    case 16:
      return mdt_swc::launch_c<16>(bf16, src, ref, sx, sy, out, B, R, W, D,
                                   H, G, stream);
    case 32:
      return mdt_swc::launch_c<32>(bf16, src, ref, sx, sy, out, B, R, W, D,
                                   H, G, stream);
    case 64:
      return mdt_swc::launch_c<64>(bf16, src, ref, sx, sy, out, B, R, W, D,
                                   H, G, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return launch(false, src, ref, sx, sy, out, B, R, W, D, H, C, G,
                static_cast<cudaStream_t>(stream));
}

int sweep_warp_corr_bf16(const void* src, const void* ref, const void* sx,
                         const void* sy, void* out, int B, int R, int W,
                         int D, int H, int C, int G, void* stream) {
  return launch(true, src, ref, sx, sy, out, B, R, W, D, H, C, G,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"

#endif  // !SWC_C
