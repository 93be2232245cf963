// K5 warp_bwd — the gradients of K4 (bilinear sampling with zeros outside
// the frame), for sm_90a.
//
// Replaces: the JAX-autodiff backward of
// dynavsr_tpu/ops/grid_sample.py:_packed_bilinear (line 54), which TOFlow's
// adaptation differentiates: the flow comes from SpyNet's parameters, so a
// gradient flows into it at every warp but the first level's (whose flow is
// zeros).
//
//   grad_flow_x[b,i,j] = sum_c g[b,c,i,j] * (wy0 (v01 - v00) + wy1 (v11 - v10))
//   grad_flow_y[b,i,j] = sum_c g[b,c,i,j] * (wx0 (v10 - v00) + wx1 (v11 - v01))
//   grad_x[b,c,y,x]   += g[b,c,i,j] * wy * wx      for each inside corner (y, x)
//
// with v = 0 for a corner outside the frame; floor contributes no gradient,
// as under JAX autodiff. grad_flow is a gather: each thread owns its pixel's
// two values and needs no atomics. It is always computed: wherever the
// backward runs, the flow comes from SpyNet's parameters and needs it.
// grad_x is a scatter (several output pixels sample one input pixel) and
// lands with fp32 atomics into a buffer the wrapper zeroes; it is computed
// only when asked for (on TOF's adaptation path x is input data and it
// never is).
//
// What bounds it on the H100: bytes, as K4 (reads x's corners, the flow and g,
// writes grad_flow; with grad_x, C atomics a corner more). At the
// adaptation shapes it runs (8 frames of 36x44 to 144x176, 0.1-3 MB) a call
// is launch-bound, and this kernel does nothing about that.
//
// Design: one thread per output pixel, all C channels, as K4; the corner
// weights and inside flags are formed once per pixel.
#include "warp_common.cuh"

namespace warp {

__global__ void __launch_bounds__(kThreads)
warp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ flow,
                const float* __restrict__ gout, float* __restrict__ gx,
                float* __restrict__ gflow, int B, int C, int H, int W) {
  const int hw = H * W;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)B * hw) return;
  const int64_t b = t / hw;
  const int p = (int)(t % hw);
  float ys, xs;
  position(flow, b, p, hw, W, &ys, &xs);
  const Corners k = make_corners(ys, xs, H, W);
  const int q = k.y0 * W + k.x0;
  float gxs = 0.f, gys = 0.f;
  for (int c = 0; c < C; ++c) {
    const float g = __ldg(gout + (b * C + c) * hw + p);
    const float* plane = x + (b * C + c) * hw;
    const float v00 = k.in00 ? __ldg(plane + q) : 0.f;
    const float v01 = k.in01 ? __ldg(plane + q + 1) : 0.f;
    const float v10 = k.in10 ? __ldg(plane + q + W) : 0.f;
    const float v11 = k.in11 ? __ldg(plane + q + W + 1) : 0.f;
    gxs += g * (k.wy0 * (v01 - v00) + k.wy1 * (v11 - v10));
    gys += g * (k.wx0 * (v10 - v00) + k.wx1 * (v11 - v01));
    if (gx) {
      float* gplane = gx + (b * C + c) * hw;
      if (k.in00) atomicAdd(gplane + q, g * (k.wy0 * k.wx0));
      if (k.in01) atomicAdd(gplane + q + 1, g * (k.wy0 * k.wx1));
      if (k.in10) atomicAdd(gplane + q + W, g * (k.wy1 * k.wx0));
      if (k.in11) atomicAdd(gplane + q + W + 1, g * (k.wy1 * k.wx1));
    }
  }
  gflow[(b * 2) * hw + p] = gxs;
  gflow[(b * 2 + 1) * hw + p] = gys;
}

}  // namespace warp

// x (B, C, H, W), flow (B, 2, H, W), gout (B, C, H, W); gx (B, C, H, W),
// zeroed by the caller, or null; gflow (B, 2, H, W). fp32, contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int warp_bwd(const void* x, const void* flow, const void* gout, void* gx,
                        void* gflow, int B, int C, int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + warp::kThreads - 1) / warp::kThreads);
  warp::warp_bwd_kernel<<<blocks, warp::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)flow, (const float*)gout, (float*)gx, (float*)gflow, B,
      C, H, W);
  return (int)cudaGetLastError();
}
