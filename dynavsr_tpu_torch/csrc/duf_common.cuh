// Shared pieces of the dynamic-upsampling-filter kernels (duf_fwd.cu,
// duf_bwd.cu): the layouts, filter loads for fp32 and bf16, and K6's
// shared-memory tile of x with its 2-pixel zero halo (K7 shapes its own).
//
// Layouts (NCHW planes, contiguous), the layout the port's DUF holds:
//   x       (B, C, H, W)         fp32, the centre frame
//   filters (B, 25, R, H, W)     fp32 or bf16; tap k = 5 i + j (row-major)
//   out     (B, C * R, H, W)     fp32, channel c * R + r
// out[b, c*R + r, h, w] = sum_k x[b, c, h + i - 2, w + j - 2] * f[b, k, r, h, w],
// zero outside the frame.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace duf {

constexpr int kTaps = 25;
constexpr int kRad = 2;
constexpr int kTileW = 32;  // a warp spans one tile row: coalesced plane accesses
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kHaloW = kTileW + 2 * kRad;
constexpr int kHaloH = kTileH + 2 * kRad;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Load the (kTileH + 4) x (kTileW + 4) window of x's C planes that the
// block's pixels read, zeros outside the frame, into `tile` (C planes of
// kHaloH x kHaloW), then wait for the whole block.
__device__ __forceinline__ void load_tile(const float* __restrict__ x, float* tile, int64_t b,
                                          int C, int H, int W, int h0, int w0) {
  const int plane = kHaloH * kHaloW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < C * plane; i += kThreads) {
    const int c = i / plane;
    const int yy = (i - c * plane) / kHaloW;
    const int xx = i - c * plane - yy * kHaloW;
    const int y = h0 + yy - kRad, xq = w0 + xx - kRad;
    tile[i] = (y >= 0 && y < H && xq >= 0 && xq < W)
                  ? __ldg(x + ((b * C + c) * H + y) * (int64_t)W + xq)
                  : 0.f;
  }
  __syncthreads();
}

}  // namespace duf
