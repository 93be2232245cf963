// K6 duf_fwd — DUF's dynamic upsampling filter, forward, for sm_90a.
//
// Replaces: dynavsr_tpu/models/duf.py:dynamic_upsampling_filter (line 47),
// the extract-25-patches + einsum that every DUF forward runs on the
// centre frame (R = scale^2 = 16 per-pixel 5x5 filters on each of its 3
// channels).
//
//   out[b, c*R + r, h, w] = sum_{k = 5i + j} x[b, c, h+i-2, w+j-2] * f[b, k, r, h, w]
//
// What bounds it on the H100: bytes. The filter tensor is 25 R values a
// pixel, read once, against C values of x and C R outputs: at DUF's
// largest call (8 windows of 144x176, C = 3, R = 16, fp32 filters) 366 MB,
// 109 us at 3.35 TB/s (61 us with bf16 filters), for 0.49 GFLOP, far below
// the card's fp32 rate. At the adaptation size (8 x 36 x 44, 23 MB) a call
// is shorter than a launch, and this kernel does nothing about that.
//
// Design: one thread per output pixel, a block per 8 x 32 pixel tile. The
// block first stages the C planes of x it reads, with a 2-pixel zero halo,
// in shared memory (C x 12 x 36 floats), so the 25 C taps a pixel reads
// never go to device memory twice and the zero padding costs no branch.
// Then for each r the thread loads its 25 filter values into registers
// (one plane each: a warp reads 32 neighbouring pixels, coalesced) and
// applies them to each of the C channels, accumulating in fp32. The TPU
// version materialises the (B, H, W, 25, C) patch tensor for an MXU
// einsum; here no patch tensor exists.
#include "duf_common.cuh"

namespace duf {

template <typename TF>
__global__ void __launch_bounds__(kThreads)
duf_fwd_kernel(const float* __restrict__ x, const TF* __restrict__ filt,
               float* __restrict__ out, int C, int R, int H, int W) {
  extern __shared__ float tile[];
  const int64_t b = blockIdx.z;
  const int h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  load_tile(x, tile, b, C, H, W, h0, w0);
  const int h = h0 + threadIdx.y, w = w0 + threadIdx.x;
  if (h >= H || w >= W) return;
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)h * W + w;
  const TF* fb = filt + b * kTaps * R * hw + p;
  float* ob = out + b * C * R * hw + p;
  // The top-left corner of this pixel's 5x5 window in the tile.
  const float* t0 = tile + threadIdx.y * kHaloW + threadIdx.x;
  for (int r = 0; r < R; ++r) {
    float f[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) f[k] = ld(fb + ((int64_t)k * R + r) * hw);
    for (int c = 0; c < C; ++c) {
      const float* tc = t0 + c * kHaloH * kHaloW;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) acc = fmaf(tc[i * kHaloW + j], f[i * 5 + j], acc);
      ob[((int64_t)c * R + r) * hw] = acc;
    }
  }
}

}  // namespace duf

// x (B, C, H, W) fp32; filt (B, 25, R, H, W) fp32 (filt_dtype 0) or bf16
// (1); out (B, C*R, H, W) fp32. Contiguous; 1 <= C <= 16, B <= 65535.
// Returns cudaGetLastError() after the launch.
extern "C" int duf_fwd(const void* x, const void* filt, void* out, int B, int C, int R,
                       int H, int W, int filt_dtype, void* stream) {
  if ((int64_t)B * H * W * R == 0) return 0;
  const dim3 grid((W + duf::kTileW - 1) / duf::kTileW, (H + duf::kTileH - 1) / duf::kTileH, B);
  const dim3 block(duf::kTileW, duf::kTileH);
  const size_t smem = (size_t)C * duf::kHaloH * duf::kHaloW * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (filt_dtype == 0) {
    duf::duf_fwd_kernel<float><<<grid, block, smem, s>>>(
        (const float*)x, (const float*)filt, (float*)out, C, R, H, W);
  } else {
    duf::duf_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        (const float*)x, (const __nv_bfloat16*)filt, (float*)out, C, R, H, W);
  }
  return (int)cudaGetLastError();
}
