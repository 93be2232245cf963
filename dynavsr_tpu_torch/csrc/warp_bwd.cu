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
// as under JAX autodiff. grad_flow is a gather: each thread owns its pixels'
// values and needs no atomics. It is always computed: wherever the backward
// runs, the flow comes from SpyNet's parameters and needs it. grad_x is a
// scatter (several output pixels sample one input pixel) and lands with
// fp32 atomics into a buffer the wrapper zeroes; it is computed only when
// asked for (on TOF's adaptation path x is input data and it never is), and
// that path is kept correct, not fast.
//
// What bounds it on the H100 (80GB HBM3, 700 W; PERF.md): bytes, and launch
// latency at the small calls. Per pixel it reads 2 flow values, C = 3
// gradient values and C samples' corners (neighbours, mostly from L1/L2)
// and writes 2 values: 10 fp32 values a pixel with each input read once,
// 8.1 MB at the largest call of the path (8 frames of 144x176), 2.4 us at
// 3.35 TB/s. Its calls (8 frames of 36x44 to 144x176) are short, so a
// thread's chain of dependent loads and the number of SMs a call reaches
// set the time more than the bytes do. The first version (one thread per
// pixel on a flat grid, 64-bit divisions for its coordinates, one scalar
// flow value and one channel's loads at a time) filled 50 of the 132 SMs at
// 36x44.
//
// Design: K4's layout for the backward. A 3-D grid (column pairs, rows,
// frames), so a thread finds its pixels with no division. A thread owns 2
// consecutive pixels of one row: where W is even (W = 176, 88, 44, 22 on the
// path) it reads their flows and each channel's gradient as float2 and
// writes each grad_flow plane as one float2; other widths take the same path
// one pixel at a time. The gradient loads do not depend on the flow and are
// issued with it; for C = 3 (TOFlow's frames) all 2 x 4 x 3 = 24 corner loads
// are issued before the first FMA, so a thread waits for two memory round
// trips (flow, then corners). The launcher shapes the block to the frame
// (launch_shape): at 36x44 one-warp blocks of 8 column pairs x 4 rows, 216
// of them, so the call reaches every SM. Whether a corner is inside is
// decided in float (warp_common.cuh:make_corners), so positions of +-1e30
// give exact zeros.
#include "warp_common.cuh"

namespace warp {

constexpr int kPx = 2;  // consecutive pixels per thread

// kC: channels handled per pass, unrolled (3), or 0 for one channel a pass
// over C taken at run time. kNeedX: also scatter grad_x.
template <int kC, bool kNeedX>
__global__ void __launch_bounds__(256)
warp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ flow,
                const float* __restrict__ gout, float* __restrict__ gx,
                float* __restrict__ gflow, int C_, int H, int W, bool vec) {
  constexpr int kCu = kC > 0 ? kC : 1;
  const int C = kC > 0 ? kC : C_;
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kPx;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j0 >= W) return;
  const int64_t hw = (int64_t)H * W, b = blockIdx.z;
  const int row = i * W + j0;
  const int n = vec ? kPx : min(kPx, W - j0);

  // Two values of a plane at this thread's pixels.
  auto load2 = [&](const float* p, float* v) {
    if (vec) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = a.x, v[1] = a.y;
    } else {
#pragma unroll
      for (int e = 0; e < kPx; ++e) v[e] = e < n ? __ldg(p + e) : 0.f;
    }
  };

  float fx[kPx], fy[kPx];
  const float* fxp = flow + b * 2 * hw + row;
  load2(fxp, fx);
  load2(fxp + hw, fy);
  Corners k[kPx];
  int q[kPx];
#pragma unroll
  for (int e = 0; e < kPx; ++e) {
    k[e] = make_corners((float)i + fy[e], (float)(j0 + e) + fx[e], H, W);
    q[e] = k[e].y0 * W + k[e].x0;
  }

  float gxs[kPx] = {}, gys[kPx] = {};
  for (int c0 = 0; c0 < C; c0 += kCu) {
    float g[kCu][kPx], v[kCu][kPx][4];
#pragma unroll
    for (int c = 0; c < kCu; ++c) {
      load2(gout + (b * C + c0 + c) * hw + row, g[c]);
      const float* plane = x + (b * C + c0 + c) * hw;
#pragma unroll
      for (int e = 0; e < kPx; ++e) {
        v[c][e][0] = k[e].in00 ? __ldg(plane + q[e]) : 0.f;
        v[c][e][1] = k[e].in01 ? __ldg(plane + q[e] + 1) : 0.f;
        v[c][e][2] = k[e].in10 ? __ldg(plane + q[e] + W) : 0.f;
        v[c][e][3] = k[e].in11 ? __ldg(plane + q[e] + W + 1) : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < kCu; ++c) {
#pragma unroll
      for (int e = 0; e < kPx; ++e) {
        const Corners& s = k[e];
        const float* u = v[c][e];
        gxs[e] += g[c][e] * (s.wy0 * (u[1] - u[0]) + s.wy1 * (u[3] - u[2]));
        gys[e] += g[c][e] * (s.wx0 * (u[2] - u[0]) + s.wx1 * (u[3] - u[1]));
        if (kNeedX && e < n) {
          float* gplane = gx + (b * C + c0 + c) * hw;
          const float gv = g[c][e];
          if (s.in00) atomicAdd(gplane + q[e], gv * (s.wy0 * s.wx0));
          if (s.in01) atomicAdd(gplane + q[e] + 1, gv * (s.wy0 * s.wx1));
          if (s.in10) atomicAdd(gplane + q[e] + W, gv * (s.wy1 * s.wx0));
          if (s.in11) atomicAdd(gplane + q[e] + W + 1, gv * (s.wy1 * s.wx1));
        }
      }
    }
  }

  float* dx = gflow + b * 2 * hw + row;
  float* dy = dx + hw;
  if (vec) {
    *reinterpret_cast<float2*>(dx) = make_float2(gxs[0], gxs[1]);
    *reinterpret_cast<float2*>(dy) = make_float2(gys[0], gys[1]);
  } else {
#pragma unroll
    for (int e = 0; e < kPx; ++e)
      if (e < n) dx[e] = gxs[e], dy[e] = gys[e];
  }
}

}  // namespace warp

// x (B, C, H, W), flow (B, 2, H, W), gout (B, C, H, W); gx (B, C, H, W),
// zeroed by the caller, or null; gflow (B, 2, H, W). fp32, contiguous;
// B <= 65535. Returns cudaGetLastError() after the launch.
extern "C" int warp_bwd(const void* x, const void* flow, const void* gout, void* gx,
                        void* gflow, int B, int C, int H, int W, void* stream) {
  if ((int64_t)B * H * W == 0) return 0;
  dim3 grid, block;
  warp::launch_shape(B, H, W, warp::kPx, &grid, &block);
  cudaStream_t s = (cudaStream_t)stream;
  const float *xp = (const float*)x, *fp = (const float*)flow, *gp = (const float*)gout;
  float *gxp = (float*)gx, *gfp = (float*)gflow;
  // Both pixels of a pair lie in the row, their planes 8-byte aligned.
  const bool vec = W % warp::kPx == 0 && warp::aligned8(flow) && warp::aligned8(gout) &&
                   warp::aligned8(gflow);
  if (C == 3 && gx)
    warp::warp_bwd_kernel<3, true><<<grid, block, 0, s>>>(xp, fp, gp, gxp, gfp, C, H, W, vec);
  else if (C == 3)
    warp::warp_bwd_kernel<3, false><<<grid, block, 0, s>>>(xp, fp, gp, gxp, gfp, C, H, W, vec);
  else if (gx)
    warp::warp_bwd_kernel<0, true><<<grid, block, 0, s>>>(xp, fp, gp, gxp, gfp, C, H, W, vec);
  else
    warp::warp_bwd_kernel<0, false><<<grid, block, 0, s>>>(xp, fp, gp, gxp, gfp, C, H, W, vec);
  return (int)cudaGetLastError();
}
