// K1 dcn_fwd — modulated deformable conv v2, forward, for sm_90a.
//
// Replaces: dynavsr_tpu/ops/dcn_fused.py:deform_conv2d_fused (the XLA
// gather-interpolate-contract kernel the JAX models run), with the
// modulate-and-contract epilogue that
// tools/pallas_consume_experiment.py:pallas_consume wrote in Pallas fused
// into the same kernel body.
//
//   out[b,o,p] = bias[o] + sum_{k,c} W[o,c,k] * m[b,g(c),k,p]
//                          * bilinear(x[b,c], p + p_k + offset[b,g(c),k,p])
//
// What bounds it on the H100 (80GB HBM3, 700 W; chip_smoke.py, PERF.md): at
// EDVR's inference call (40 frames of 144x176, C = Cout = 64, Gd 8) the
// function moves 0.70 GB in bf16 (offset and mask are 62 % of it: 0.208 ms
// at 3.35 TB/s) against 74.7 GFLOP (0.076 ms at 989 TFLOP/s): bytes bound
// it. In fp32 it moves 1.40 GB (0.416 ms) and, with TF32 off, its FMAs on
// the CUDA cores bound it (1.116 ms at 67 TFLOP/s). What the card spends
// is neither: it is the gather, 73 M (pixel, tap, group) samples of 4
// corners each, whose positions depend on loaded offsets, so every sample
// is a dependent chain of loads. The first version of this kernel ran its
// product as fp32 FMAs in both dtypes, gathered one element at a time from
// NCHW planes, never overlapped the gather with the product, and reloaded
// every weight slice per step from device memory.
//
// Design. GEMM view: M = output pixels, N = Cout, K = 9 taps x C. A block
// owns 64 output channels and walks pixel tiles of 128 (a persistent grid:
// two blocks an SM). One step is one (tap, 64-channel chunk): its column
// tile (128 px x 64 ch) is mask x bilinear sample, formed in fp32 and
// stored in shared memory in the dtype of the product.
//  - bf16: the product runs on the tensor cores, mma.sync.m16n8k16 with
//    bf16 operands and fp32 accumulators (the column tile is rounded to
//    bf16 once, as JAX's kernel casts its columns to the compute dtype).
//    Column and weight tiles are stored XOR-swizzled in 16-byte chunks so
//    the ldmatrix reads and the gather's 16-byte stores are conflict-free.
//    mma.sync rather than wgmma: the tensor cores are not what bounds K1
//    (the product is a small part of its time); a warp-level product keeps
//    the gather and the product in the same warps, each warp running its
//    share of the product between issuing its corner loads and using them.
//  - fp32: IEEE fp32 FMAs (TF32 would miss the 1e-4 tolerance), an 8 px x
//    4 out-channel register tile per thread, float4 shared-memory reads.
//  - Weights: each step's 64 x 64 slice is copied into a two-slot ring by
//    cp.async, one step ahead, from L2 (the whole weight is 72 KB in bf16).
//    Keeping all 9 slices resident, the first plan, costs 72 KB of each
//    block's shared memory and so most of the SM's L1, which the corner
//    loads need more: on EDVR's own inputs the resident build was slower.
//  - Gather (dcn_common.cuh, shared with K2 and K3): x is read
//    channels-last (B, H, W, C), copied by a prologue kernel, so the 8
//    channels of one (pixel, tap, group) sample are one 16-byte load per
//    corner in bf16 (two in fp32). A lane owns 4
//    consecutive pixels of one 8-channel group: their offsets and masks of
//    a step are one vector load each, prefetched at the step's start; the 8
//    lanes of a quarter-warp are the 8 groups of one pixel, so where the
//    groups' offsets fall on the same corner pixels (as EDVR's do) one
//    128-byte line serves all 8. Corners outside the frame are read at
//    their clamped position with weight 0, as the plain version does, so
//    every load is unconditional (positions clamped into [-2, size + 1] as
//    dcn_common.cuh:make_sample does).
//  - Overlap: the column and weight tiles are double-buffered, one barrier
//    a step. A step is 4 rounds; in round r a thread issues the corner
//    loads of its unit of the NEXT step (in bf16 also round r + 1's), runs
//    the product of 16 channels of the CURRENT step, then blends the
//    corners that arrived into the other buffer.
// Shapes the vector gather does not take (C or C / Gd not a multiple of 8)
// gather element by element, with the same arithmetic.
#include <stdint.h>

#include <algorithm>

#include "dcn_fwd.cuh"

namespace dcn {
namespace fwd {

// K1: items are the tpf tiles of each frame, one split.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dcn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
               const T* __restrict__ mask, const T* __restrict__ wt,
               const T* __restrict__ bias, T* __restrict__ out, int B, int C, int H, int W,
               int Cout, int gd, int tpf, int ntiles, int nch, bool quads) {
  fwd_body<T, kVec, false>(x, offset, mask, nullptr, wt, bias, out, nullptr, B, C, H, W, Cout, gd,
                           tpf, ntiles, nch, 1, 0, quads);
}

// NCHW -> channels-last (B, H*W, C) copy of x, through a 32 x 32 tile in
// shared memory so both the reads (along pixels) and the writes (along
// channels) are coalesced.
template <typename T>
__global__ void __launch_bounds__(256) to_channels_last(const T* __restrict__ x,
                                                        T* __restrict__ xcl, int C, int hw) {
  __shared__ T tile[32][33];
  const int64_t b = blockIdx.z;
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, p = p0 + threadIdx.x;
    if (c < C && p < hw) tile[i][threadIdx.x] = x[(b * C + c) * hw + p];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int p = p0 + i, c = c0 + threadIdx.x;
    if (c < C && p < hw) xcl[(b * hw + p) * C + c] = tile[threadIdx.x][i];
  }
}

template <typename T, bool kVec>
static int launch(const void* x, void* xcl, const void* offset, const void* mask,
                  const void* wt, const void* bias, void* out, int B, int C, int H, int W,
                  int Cout, int gd, cudaStream_t stream) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  const int hw = H * W;
  const size_t smem = (2 * kP * kCK + 2 * kCK * kN) * sizeof(T);  // bf16 48 KB, fp32 96 KB
  auto kernel = dcn_fwd_kernel<T, kVec>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (x != xcl)  // x == xcl: the caller's x is channels-last already
    to_channels_last<T><<<dim3((hw + 31) / 32, (C + 31) / 32, B), dim3(32, 8), 0, stream>>>(
        (const T*)x, (T*)xcl, C, hw);
  const int tpf = (hw + kP - 1) / kP, ntiles = B * tpf, gy = (Cout + kN - 1) / kN;
  const int gx = std::min(ntiles, std::max(1, per_sm * nsm / gy));
  // Offsets and masks load 4 pixels at a time where every plane starts aligned.
  const bool quads = hw % 4 == 0 && (uintptr_t)offset % 16 == 0 && (uintptr_t)mask % 16 == 0;
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      (const T*)xcl, (const T*)offset, (const T*)mask, (const T*)wt, (const T*)bias, (T*)out, B,
      C, H, W, Cout, gd, tpf, ntiles, (C + kCK - 1) / kCK, quads);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* x, void* xcl, const void* offset, const void* mask,
                    const void* wt, const void* bias, void* out, int B, int C, int H, int W,
                    int Cout, int gd, cudaStream_t s) {
  if (C % kSeg == 0 && (C / gd) % kSeg == 0)
    return launch<T, true>(x, xcl, offset, mask, wt, bias, out, B, C, H, W, Cout, gd, s);
  return launch<T, false>(x, xcl, offset, mask, wt, bias, out, B, C, H, W, Cout, gd, s);
}

}  // namespace fwd
}  // namespace dcn

// x, offset, mask and out NCHW (dcn_common.cuh); xcl: scratch of x's size
// for its channels-last copy. wt: bf16 (9, Cout, C), fp32 (9, C, Cout).
// dtype: 0 = float32, 1 = bfloat16 (all tensors share it). mask and bias
// may be null. Returns cudaGetLastError() after the launches.
extern "C" int dcn_fwd(const void* x, void* xcl, const void* offset, const void* mask,
                       const void* wt, const void* bias, void* out, int B, int C, int H, int W,
                       int Cout, int gd, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || H * W == 0 || Cout == 0) return 0;
  if (dtype == 0)
    return dcn::fwd::dispatch<float>(x, xcl, offset, mask, wt, bias, out, B, C, H, W, Cout, gd,
                                     s);
  if (dtype == 1)
    return dcn::fwd::dispatch<__nv_bfloat16>(x, xcl, offset, mask, wt, bias, out, B, C, H, W,
                                             Cout, gd, s);
  return (int)cudaErrorInvalidValue;
}
