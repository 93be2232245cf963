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
// What bounds it on the H100 (80GB HBM3, 700 W; PERF.md): bytes. Per output
// pixel it reads the 2 flow values and C = 3 samples' corners (mostly
// neighbours, served by L1/L2) and writes C values: with each input read
// once, 8 fp32 values a pixel. At the largest call of the TOF path (8
// frames of 576x704) that is 104 MB, 0.031 ms at 3.35 TB/s; its ~40
// operations a pixel are far below the card's rate. The first version (one
// thread per pixel on a flat grid, 64-bit divisions for its coordinates,
// one flow value and one corner at a time) took 0.064 ms, 1.33x
// F.grid_sample's time: too few bytes in flight per thread to cover the
// memory latency. At the adaptation shapes (8 frames of 18x22 to 144x176,
// 0.1-7 MB) a call is shorter than a launch: those calls are launch-bound,
// and this kernel does nothing about that.
//
// Design: a 3-D grid (column blocks, row blocks, frames), so a thread finds
// its pixels with no division. A thread owns 2 consecutive pixels of one
// row: where W is even (W = 704, 352, 176, 88, 44, 22 on the path) it reads
// their flows as two float2 and writes each channel's 2 outputs as one
// float2; other widths take the same path one pixel at a time. For C = 3
// (TOFlow's frames) the channel loop is unrolled, so all 2 x 4 x 3 = 24
// corner loads are issued before the first is used. Two pixels rather than
// four keep a thread at ~40 registers, so more threads (and their loads)
// are in flight on each SM. Whether a corner is inside is
// decided in float (warp_common.cuh:make_corners), so positions of +-1e30
// give exact zeros.
#include "warp_common.cuh"

namespace warp {

constexpr int kPx = 2;                 // consecutive pixels per thread
constexpr int kBx = 32, kBy = 8;       // threads per block: 64 columns x 8 rows

template <int kC>  // channels (unrolled), or 0 for C taken at run time
__global__ void __launch_bounds__(kBx * kBy)
warp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flow,
                float* __restrict__ out, int C_, int H, int W) {
  const int C = kC > 0 ? kC : C_;
  const int j0 = (blockIdx.x * kBx + threadIdx.x) * kPx;
  const int i = blockIdx.y * kBy + threadIdx.y;
  if (i >= H || j0 >= W) return;
  const int64_t hw = (int64_t)H * W, b = blockIdx.z;
  const int row = i * W + j0;
  const bool vec = (W % kPx) == 0;  // then both pixels lie in the row, 8-byte aligned
  const int n = vec ? kPx : min(kPx, W - j0);

  float fx[kPx], fy[kPx];
  const float* fxp = flow + b * 2 * hw + row;
  const float* fyp = fxp + hw;
  if (vec) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(fxp));
    const float2 c = __ldg(reinterpret_cast<const float2*>(fyp));
    fx[0] = a.x, fx[1] = a.y, fy[0] = c.x, fy[1] = c.y;
  } else {
#pragma unroll
    for (int e = 0; e < kPx; ++e) {
      fx[e] = e < n ? __ldg(fxp + e) : 0.f;
      fy[e] = e < n ? __ldg(fyp + e) : 0.f;
    }
  }

  Corners k[kPx];
  int q[kPx];
#pragma unroll
  for (int e = 0; e < kPx; ++e) {
    k[e] = make_corners((float)i + fy[e], (float)(j0 + e) + fx[e], H, W);
    q[e] = k[e].y0 * W + k[e].x0;
  }

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float* plane = x + (b * C + c) * hw;
    float v[kPx][4];
#pragma unroll
    for (int e = 0; e < kPx; ++e) {
      v[e][0] = k[e].in00 ? __ldg(plane + q[e]) : 0.f;
      v[e][1] = k[e].in01 ? __ldg(plane + q[e] + 1) : 0.f;
      v[e][2] = k[e].in10 ? __ldg(plane + q[e] + W) : 0.f;
      v[e][3] = k[e].in11 ? __ldg(plane + q[e] + W + 1) : 0.f;
    }
    float o[kPx];
#pragma unroll
    for (int e = 0; e < kPx; ++e) {
      const Corners& s = k[e];
      // The JAX function's order of the four products.
      o[e] = (s.wy0 * s.wx0) * v[e][0] + (s.wy0 * s.wx1) * v[e][1] +
             (s.wy1 * s.wx0) * v[e][2] + (s.wy1 * s.wx1) * v[e][3];
    }
    float* dst = out + (b * C + c) * hw + row;
    if (vec) {
      *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
    } else {
#pragma unroll
      for (int e = 0; e < kPx; ++e)
        if (e < n) dst[e] = o[e];
    }
  }
}

}  // namespace warp

// x (B, C, H, W), flow (B, 2, H, W), out (B, C, H, W); fp32, contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int warp_fwd(const void* x, const void* flow, void* out, int B, int C, int H,
                        int W, void* stream) {
  if ((int64_t)B * C * H * W == 0) return 0;
  const int cols = (W + warp::kPx - 1) / warp::kPx;
  dim3 block(warp::kBx, warp::kBy);
  dim3 grid((cols + warp::kBx - 1) / warp::kBx, (H + warp::kBy - 1) / warp::kBy, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 3)
    warp::warp_fwd_kernel<3><<<grid, block, 0, s>>>((const float*)x, (const float*)flow,
                                                    (float*)out, C, H, W);
  else
    warp::warp_fwd_kernel<0><<<grid, block, 0, s>>>((const float*)x, (const float*)flow,
                                                    (float*)out, C, H, W);
  return (int)cudaGetLastError();
}
