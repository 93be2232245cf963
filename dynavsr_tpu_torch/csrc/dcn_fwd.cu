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
// What bounds it on the H100: at the main path's L1 shape (80 frames of
// 144x176, C = Cout = 64, Gd = 8, bf16) the function moves ~1.4 GB of
// input/output (offset and mask dominate) against 149.5 GFLOP, so the
// card's floor is memory (~0.42 ms at 3.35 TB/s). This first kernel does
// its contraction with fp32 FMAs on the CUDA cores (67 TFLOP/s peak), so it
// is bound by those operations (>= 2.2 ms) until a later version moves the
// contraction onto wgmma.
//
// Design: one block = 64 output pixels of one frame x 64 output channels.
// For each tap k and 64-channel input chunk the block bilinear-samples the
// chunk into a shared-memory column tile (scaled by corner weight x mask,
// positions in fp32), loads the matching (C, Cout) weight slice, and
// accumulates their product into fp32 registers (4 px x 4 out-channels a
// thread). No im2col tensor ever reaches device memory; x, offset and mask
// are read once per block. Bias is added and the output written in the
// input's dtype.
#include "dcn_common.cuh"

namespace dcn {

// wt: weight transposed to (9, C, Cout) so a tile load is coalesced.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
               const T* __restrict__ mask, const T* __restrict__ wt,
               const T* __restrict__ bias, T* __restrict__ out, int C, int H, int W,
               int Cout, int gd, int tiles_per_frame) {
  __shared__ float col[kTileC * kTileP];
  __shared__ float wsm[kTileC * kTileO];

  const int hw = H * W;
  const int b = blockIdx.x / tiles_per_frame;
  const int p0 = (blockIdx.x % tiles_per_frame) * kTileP;
  const int o0 = blockIdx.y * kTileO;
  const int tp = threadIdx.x % 16, to = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kTaps; ++k) {
    for (int c0 = 0; c0 < C; c0 += kTileC) {
      fill_columns(col, kTileP, x, offset, mask, b, k, c0, p0, C, H, W, gd);
      for (int e = threadIdx.x; e < kTileC * kTileO; e += kThreads) {
        const int cl = e / kTileO, ol = e % kTileO;
        const int c = c0 + cl, o = o0 + ol;
        wsm[e] = (c < C && o < Cout) ? ld(wt + ((int64_t)k * C + c) * Cout + o) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cl = 0; cl < kTileC; ++cl) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = col[cl * kTileP + tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = wsm[cl * kTileO + to + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + to + 16 * j;
    if (o >= Cout) continue;
    const float bo = bias ? ld(bias + o) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pix = p0 + tp + 16 * i;
      if (pix < hw) st(out + ((int64_t)b * Cout + o) * hw + pix, acc[i][j] + bo);
    }
  }
}

template <typename T>
static int launch(const void* x, const void* offset, const void* mask, const void* wt,
                  const void* bias, void* out, int B, int C, int H, int W, int Cout, int gd,
                  cudaStream_t stream) {
  const int tpf = (H * W + kTileP - 1) / kTileP;
  dim3 grid(B * tpf, (Cout + kTileO - 1) / kTileO);
  dcn_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)offset, (const T*)mask, (const T*)wt, (const T*)bias, (T*)out,
      C, H, W, Cout, gd, tpf);
  return (int)cudaGetLastError();
}

}  // namespace dcn

// dtype: 0 = float32, 1 = bfloat16 (all tensors share it). mask and bias
// may be null. Returns cudaGetLastError() after the launch.
extern "C" int dcn_fwd(const void* x, const void* offset, const void* mask, const void* wt,
                       const void* bias, void* out, int B, int C, int H, int W, int Cout,
                       int gd, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dcn::launch<float>(x, offset, mask, wt, bias, out, B, C, H, W, Cout, gd, s);
  if (dtype == 1)
    return dcn::launch<__nv_bfloat16>(x, offset, mask, wt, bias, out, B, C, H, W, Cout, gd,
                                      s);
  return (int)cudaErrorInvalidValue;
}
