// K4 warp_fwd — bilinear sampling with zeros outside the frame, for sm_90a.
//
// Replaces: dynavsr_tpu/ops/grid_sample.py:_packed_bilinear (line 54), the
// XLA gather behind grid_sample and flow_warp that TOFlow's SpyNet (4 warps
// per neighbour) and its final warp run.
//
//   out[b,c,i,j] = sum over the 4 corners (y, x) of
//                  wy * wx * x[b,c,y,x]   (0 for a corner outside the frame)
//   at (ys, xs) = (i + flow_y, j + flow_x).
//
// What bounds it on the H100: bytes. Per output pixel it reads the 2 flow
// values and C = 3 samples' corners (mostly neighbours, served by L1/L2)
// and writes C values: with each input read once, 8 fp32 values a pixel.
// At the largest call of the TOF path (8 frames of 576x704) that is
// 104 MB, ~31 us at 3.35 TB/s; its ~40 operations a pixel are far below
// the card's rate. At the adaptation shapes (8 frames of 18x22 to 144x176,
// 0.1-7 MB) a call is shorter than a launch: those calls are launch-bound,
// and this kernel does nothing about that.
//
// Design: one thread per output pixel computes all C channels, so the
// corner weights and the inside test are formed once per pixel. Neighbouring
// threads take neighbouring pixels of one plane: the flow reads and the
// output writes are coalesced, and for small flows the corner reads of a
// warp fall on a few cache lines. The TPU version packs the 4 corners into
// one 4C-lane row because TPU row gathers are row-count bound; Hopper
// gathers through L1 without that cost, so no packed copy of x is made.
#include "warp_common.cuh"

namespace warp {

__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flow,
                float* __restrict__ out, int B, int C, int H, int W) {
  const int hw = H * W;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)B * hw) return;
  const int64_t b = t / hw;
  const int p = (int)(t % hw);
  float ys, xs;
  position(flow, b, p, hw, W, &ys, &xs);
  const Corners k = make_corners(ys, xs, H, W);
  const float w00 = k.wy0 * k.wx0, w01 = k.wy0 * k.wx1;
  const float w10 = k.wy1 * k.wx0, w11 = k.wy1 * k.wx1;
  const int q = k.y0 * W + k.x0;
  for (int c = 0; c < C; ++c) {
    const float* plane = x + (b * C + c) * hw;
    const float v00 = k.in00 ? __ldg(plane + q) : 0.f;
    const float v01 = k.in01 ? __ldg(plane + q + 1) : 0.f;
    const float v10 = k.in10 ? __ldg(plane + q + W) : 0.f;
    const float v11 = k.in11 ? __ldg(plane + q + W + 1) : 0.f;
    // The JAX function's order of the four products.
    out[(b * C + c) * hw + p] = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
  }
}

}  // namespace warp

// x (B, C, H, W), flow (B, 2, H, W), out (B, C, H, W); fp32, contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int warp_fwd(const void* x, const void* flow, void* out, int B, int C, int H,
                        int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + warp::kThreads - 1) / warp::kThreads);
  warp::warp_fwd_kernel<<<blocks, warp::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)flow, (float*)out, B, C, H, W);
  return (int)cudaGetLastError();
}
