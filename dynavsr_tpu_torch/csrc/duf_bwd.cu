// K7 duf_bwd — the gradients of K6 (DUF's dynamic upsampling filter), for
// sm_90a.
//
// Replaces: the JAX-autodiff backward of
// dynavsr_tpu/models/duf.py:dynamic_upsampling_filter (line 47), which every
// DUF adaptation step runs: the loss flows back into the filters, which
// come from the filter head's parameters.
//
//   grad_f[b, k, r, h, w] = sum_c x[b, c, h+i-2, w+j-2] * g[b, c*R + r, h, w]
//   grad_x[b, c, y, x]    = sum_{i, j} sum_r g[b, c*R + r, y+2-i, x+2-j]
//                                          * f[b, 5i+j, r, y+2-i, x+2-j]
//
// over the (y+2-i, x+2-j) inside the frame. Both are gathers: each thread
// owns the values it writes, so there are no atomics and the result is
// the same from run to run. grad_f is always computed (written in the
// filters' dtype); grad_x only when asked for (on DUF's path x is input
// data and it never is).
//
// What bounds it on the H100: bytes, as K6 (reads x and g, writes grad_f:
// 25 R values a pixel; with grad_x, also reads f). At the adaptation size it
// runs (8 x 36 x 44, 23 MB) a call is launch-bound, and this kernel does
// nothing about that.
//
// Design: grad_f as K6 — one thread per pixel, x's tile with its halo in
// shared memory; for each r the thread reads the C gradient values of its
// pixel and forms its 25 filter gradients in registers, then writes them
// (one plane each, coalesced). grad_x: one thread per (b, c, y, x), summing
// over the <= 25 output pixels that read it and their R filters.
#include "duf_common.cuh"

namespace duf {

template <typename TF>
__global__ void __launch_bounds__(kThreads)
duf_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               TF* __restrict__ gf, int C, int R, int H, int W) {
  extern __shared__ float tile[];
  const int64_t b = blockIdx.z;
  const int h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  load_tile(x, tile, b, C, H, W, h0, w0);
  const int h = h0 + threadIdx.y, w = w0 + threadIdx.x;
  if (h >= H || w >= W) return;
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)h * W + w;
  const float* gb = g + b * C * R * hw + p;
  TF* gfb = gf + b * kTaps * R * hw + p;
  const float* t0 = tile + threadIdx.y * kHaloW + threadIdx.x;
  for (int r = 0; r < R; ++r) {
    float acc[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc[k] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float gv = __ldg(gb + ((int64_t)c * R + r) * hw);
      const float* tc = t0 + c * kHaloH * kHaloW;
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          acc[i * 5 + j] = fmaf(tc[i * kHaloW + j], gv, acc[i * 5 + j]);
        }
    }
#pragma unroll
    for (int k = 0; k < kTaps; ++k) st(gfb + ((int64_t)k * R + r) * hw, acc[k]);
  }
}

template <typename TF>
__global__ void __launch_bounds__(kThreads)
duf_bwd_x_kernel(const TF* __restrict__ filt, const float* __restrict__ g,
                 float* __restrict__ gx, int B, int C, int R, int H, int W) {
  const int64_t hw = (int64_t)H * W;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)B * C * hw) return;
  const int64_t bc = t / hw;
  const int p = (int)(t - bc * hw);
  const int64_t b = bc / C;
  const int c = (int)(bc - b * C);
  const int y = p / W, xq = p - (p / W) * W;
  float acc = 0.f;
  for (int i = 0; i < 5; ++i) {
    const int py = y + kRad - i;
    if (py < 0 || py >= H) continue;
    for (int j = 0; j < 5; ++j) {
      const int px = xq + kRad - j;
      if (px < 0 || px >= W) continue;
      const int64_t q = (int64_t)py * W + px;
      const TF* fq = filt + (b * kTaps + i * 5 + j) * R * hw + q;
      const float* gq = g + (b * C + c) * R * hw + q;
      for (int r = 0; r < R; ++r) acc = fmaf(__ldg(gq + r * hw), ld(fq + r * hw), acc);
    }
  }
  gx[t] = acc;
}

template <typename TF>
int launch(const float* x, const TF* filt, const float* gout, TF* gfilt, float* gx, int B,
           int C, int R, int H, int W, cudaStream_t s) {
  if (gfilt) {
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
    const size_t smem = (size_t)C * kHaloH * kHaloW * sizeof(float);
    duf_bwd_kernel<TF><<<grid, dim3(kTileW, kTileH), smem, s>>>(x, gout, gfilt, C, R, H, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (gx) {
    const int64_t n = (int64_t)B * C * H * W;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    duf_bwd_x_kernel<TF><<<blocks, kThreads, 0, s>>>(filt, gout, gx, B, C, R, H, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace duf

// x (B, C, H, W) fp32; filt (B, 25, R, H, W) fp32 (filt_dtype 0) or bf16
// (1); gout (B, C*R, H, W) fp32; gfilt like filt, or null; gx like x, or
// null. Contiguous; 1 <= C <= 16, B <= 65535. Returns cudaGetLastError()
// after the launches.
extern "C" int duf_bwd(const void* x, const void* filt, const void* gout, void* gfilt,
                       void* gx, int B, int C, int R, int H, int W, int filt_dtype,
                       void* stream) {
  if ((int64_t)B * H * W * R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (filt_dtype == 0) {
    return duf::launch<float>((const float*)x, (const float*)filt, (const float*)gout,
                              (float*)gfilt, (float*)gx, B, C, R, H, W, s);
  }
  return duf::launch<__nv_bfloat16>((const float*)x, (const __nv_bfloat16*)filt,
                                    (const float*)gout, (__nv_bfloat16*)gfilt, (float*)gx, B,
                                    C, R, H, W, s);
}
