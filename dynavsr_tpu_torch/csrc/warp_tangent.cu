// K11 warp_fwd_tangent and K12 warp_bwd_tangent — the second order of the
// bilinear warp (K4, zeros outside the frame), for sm_90a: one kernel that
// computes K11's and K12's outputs, each on request, in one pass.
//
// Replaces: the second-order JAX autodiff of
// dynavsr_tpu/ops/grid_sample.py:_packed_bilinear (line 54) that DynaVSR's
// meta-training of TOFlow takes (dynavsr_tpu/train/meta.py: the inner
// gradient differentiated again). With out = W(x, flow) and K5 its VJP,
// the backward of K5 along the flow cotangent cf needs two functions that
// no first-order kernel computes (ops/grid_sample.py:WarpBwdFunction):
//
//   K11  T[b,c,i,j] = cf_x * (wy0 (v01 - v00) + wy1 (v11 - v10))
//                   + cf_y * (wx0 (v10 - v00) + wx1 (v11 - v01))
//        the tangent forward: d out / d flow along cf (into grad_out);
//   K12  grad_flow_x[b,i,j] = cf_y * sum_c g * (v00 - v01 - v10 + v11)
//        grad_flow_y[b,i,j] = cf_x * sum_c g * (v00 - v01 - v10 + v11)
//        (a bilinear sample has no d2/dx2 or d2/dy2 off the grid lines,
//        only the cross term), and on request grad_x: g times each corner
//        weight's derivative along cf, scattered into the four corners
//        with fp32 atomics into a buffer the wrapper zeroes, as K5's.
//
// v = 0 for a corner outside the frame; floor contributes no derivative, as
// under JAX autodiff. ops/grid_sample_ref.py:warp_fwd_tangent_ref and
// warp_bwd_tangent_ref are the same formulas in plain PyTorch.
//
// What bounds it on the H100 (80GB HBM3, 700 W; PERF.md): bytes, and at
// TOF's meta shapes launch latency. T reads x (C values), the flow and cf
// (4) and writes C values a pixel; grad flow reads grad_out (C) besides and
// writes 2 (+ C with grad x). The double backward asks for T and grad flow
// together: 3C + 6 fp32 values a pixel with each input read once (15 for
// TOFlow's C = 3, where two separate kernels moved 22), 2.0 MB at the meta
// inner step's 8 x 3 x 64^2 (0.6 us at 3.35 TB/s), 31.5 MB at the outer
// 8 x 3 x 256^2 (9.4 us). Its ~20-40 operations a pixel a channel are far
// below the card's rate.
//
// Design: K5's layout, fitted to such elementwise gathers with a per-pixel
// 2x2 stencil. A 3-D grid (column pairs, rows, frames), so a thread finds
// its pixels with no division; 2 consecutive pixels a thread, whose flows,
// tangents, gradients and T load and store as float2 where W is even and
// the planes 8-byte aligned (other widths take the same path one pixel at a
// time); for C = 3 (TOFlow's frames) the channel loop is unrolled so all 24
// corner loads are issued before the first is used; the block fitted to
// the frame (warp_common.cuh:launch_shape), so the small calls reach every
// SM. Whether a corner is inside is decided in float
// (warp_common.cuh:make_corners). The outputs are template flags (kT, kG,
// kX), so a launch reads and computes only what they need: at the meta
// shapes each launch costs the host ~20 us against ~2 us on the device, and
// the double backward's T and grad flow, two launches before, are one.
#include "warp_common.cuh"

namespace warp {

constexpr int kPx = 2;  // consecutive pixels per thread

// Two values of a plane at a thread's pixels (n of them valid).
__device__ __forceinline__ void load2(const float* p, bool vec, int n, float* v) {
  if (vec) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x, v[1] = a.y;
  } else {
#pragma unroll
    for (int e = 0; e < kPx; ++e) v[e] = e < n ? __ldg(p + e) : 0.f;
  }
}

__device__ __forceinline__ void store2(float* p, bool vec, int n, const float* v) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < kPx; ++e)
      if (e < n) p[e] = v[e];
  }
}

// The four corner values of a sample in one plane (0 outside the frame).
__device__ __forceinline__ void corners4(const float* plane, const Corners& s, int q, int W,
                                         float* v) {
  v[0] = s.in00 ? __ldg(plane + q) : 0.f;
  v[1] = s.in01 ? __ldg(plane + q + 1) : 0.f;
  v[2] = s.in10 ? __ldg(plane + q + W) : 0.f;
  v[3] = s.in11 ? __ldg(plane + q + W + 1) : 0.f;
}

// The outputs of a launch (bits of kOut): T, grad flow, grad x (grad x
// and grad flow both need grad_out; grad x comes only with grad flow).
constexpr int kT = 1, kG = 2, kX = 4;

// kC: channels handled per pass, unrolled (3), or 0 for one channel a pass
// over C taken at run time.
template <int kC, int kOut>
__global__ void __launch_bounds__(256)
warp_bwd_tangent_kernel(const float* __restrict__ x, const float* __restrict__ flow,
                        const float* __restrict__ gout, const float* __restrict__ cflow,
                        float* __restrict__ t_out, float* __restrict__ gx,
                        float* __restrict__ gflow, int C_, int H, int W, bool vec) {
  constexpr bool kWantT = kOut & kT, kWantG = kOut & kG, kWantX = kOut & kX;
  constexpr int kCu = kC > 0 ? kC : 1;
  const int C = kC > 0 ? kC : C_;
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kPx;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j0 >= W) return;
  const int64_t hw = (int64_t)H * W, b = blockIdx.z;
  const int row = i * W + j0;
  const int n = vec ? kPx : min(kPx, W - j0);

  float fx[kPx], fy[kPx], cx[kPx], cy[kPx];
  const float* fp = flow + b * 2 * hw + row;
  const float* cp = cflow + b * 2 * hw + row;
  load2(fp, vec, n, fx);
  load2(fp + hw, vec, n, fy);
  load2(cp, vec, n, cx);
  load2(cp + hw, vec, n, cy);
  Corners k[kPx];
  int q[kPx];
#pragma unroll
  for (int e = 0; e < kPx; ++e) {
    k[e] = make_corners((float)i + fy[e], (float)(j0 + e) + fx[e], H, W);
    q[e] = k[e].y0 * W + k[e].x0;
  }

  float cross[kPx] = {};  // sum_c g * (v00 - v01 - v10 + v11)
  for (int c0 = 0; c0 < C; c0 += kCu) {
    float g[kCu][kPx], v[kCu][kPx][4];
#pragma unroll
    for (int c = 0; c < kCu; ++c) {
      if constexpr (kWantG) load2(gout + (b * C + c0 + c) * hw + row, vec, n, g[c]);
      const float* plane = x + (b * C + c0 + c) * hw;
#pragma unroll
      for (int e = 0; e < kPx; ++e) corners4(plane, k[e], q[e], W, v[c][e]);
    }
#pragma unroll
    for (int c = 0; c < kCu; ++c) {
      if constexpr (kWantT) {
        float o[kPx];
#pragma unroll
        for (int e = 0; e < kPx; ++e) {
          const Corners& s = k[e];
          const float* u = v[c][e];
          o[e] = (s.wy0 * (u[1] - u[0]) + s.wy1 * (u[3] - u[2])) * cx[e] +
                 (s.wx0 * (u[2] - u[0]) + s.wx1 * (u[3] - u[1])) * cy[e];
        }
        store2(t_out + (b * C + c0 + c) * hw + row, vec, n, o);
      }
      if constexpr (kWantG) {
#pragma unroll
        for (int e = 0; e < kPx; ++e) {
          const float* u = v[c][e];
          cross[e] += g[c][e] * (u[0] - u[1] - u[2] + u[3]);
          if (kWantX && e < n) {
            const Corners& s = k[e];
            float* gplane = gx + (b * C + c0 + c) * hw;
            const float gv = g[c][e], tx = cx[e], ty = cy[e];
            if (s.in00) atomicAdd(gplane + q[e], gv * (-tx * s.wy0 - ty * s.wx0));
            if (s.in01) atomicAdd(gplane + q[e] + 1, gv * (tx * s.wy0 - ty * s.wx1));
            if (s.in10) atomicAdd(gplane + q[e] + W, gv * (-tx * s.wy1 + ty * s.wx0));
            if (s.in11) atomicAdd(gplane + q[e] + W + 1, gv * (tx * s.wy1 + ty * s.wx1));
          }
        }
      }
    }
  }

  if constexpr (kWantG) {
    float dx[kPx], dy[kPx];
#pragma unroll
    for (int e = 0; e < kPx; ++e) dx[e] = cross[e] * cy[e], dy[e] = cross[e] * cx[e];
    float* gp = gflow + b * 2 * hw + row;
    store2(gp, vec, n, dx);
    store2(gp + hw, vec, n, dy);
  }
}

// The kernel of a launch with outputs `out` (null for a set no caller asks for).
template <int kC>
static auto kernel_for(int out) {
  return out == kT             ? &warp_bwd_tangent_kernel<kC, kT>
         : out == kG           ? &warp_bwd_tangent_kernel<kC, kG>
         : out == (kG | kX)    ? &warp_bwd_tangent_kernel<kC, kG | kX>
         : out == (kT | kG)    ? &warp_bwd_tangent_kernel<kC, kT | kG>
         : out == (kT | kG | kX) ? &warp_bwd_tangent_kernel<kC, kT | kG | kX>
                               : nullptr;
}

}  // namespace warp

// x (B, C, H, W), flow and cflow (B, 2, H, W); each output on request
// (null: not computed): t_out (B, C, H, W), K11's T; gflow (B, 2, H, W),
// K12's grad flow, which needs gout (B, C, H, W); gx (B, C, H, W), zeroed
// by the caller, K12's grad x, only with gflow. fp32, contiguous; B <=
// 65535. Returns cudaGetLastError() after the launch.
extern "C" int warp_bwd_tangent(const void* x, const void* flow, const void* gout,
                                const void* cflow, void* t_out, void* gx, void* gflow, int B,
                                int C, int H, int W, void* stream) {
  const int out = (t_out ? warp::kT : 0) | (gflow ? warp::kG : 0) | (gx ? warp::kX : 0);
  if (gflow && !gout) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H * W == 0) return 0;
  dim3 grid, block;
  warp::launch_shape(B, H, W, warp::kPx, &grid, &block);
  const bool vec = W % warp::kPx == 0 && warp::aligned8(flow) && warp::aligned8(cflow) &&
                   (!t_out || warp::aligned8(t_out)) &&
                   (!gflow || (warp::aligned8(gout) && warp::aligned8(gflow)));
  const auto kernel = C == 3 ? warp::kernel_for<3>(out) : warp::kernel_for<0>(out);
  if (!kernel) return (int)cudaErrorInvalidValue;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)flow, (const float*)gout, (const float*)cflow,
      (float*)t_out, (float*)gx, (float*)gflow, C, H, W, vec);
  return (int)cudaGetLastError();
}
