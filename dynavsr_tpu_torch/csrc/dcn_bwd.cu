// K2 dcn_bwd_data and K3 dcn_bwd_weight — the modulated deformable conv's
// backward, for sm_90a.
//
// Replaces: the JAX autodiff of dynavsr_tpu/ops/dcn_fused.py:
// deform_conv2d_fused (gather VJP -> scatter-add into x, analytic offset and
// mask gradients, the weight contraction's transpose). Adaptation takes
// this gradient on every step, so serving needs it.
//
// K2, per block = 64 pixels of one frame x 64 input channels, per tap k:
//   grad_col[c,p] = sum_o W[o,c,k] * grad_out[b,o,p]   (in-kernel, fp32)
// then for each (c, p) with its group g and sample v = bilinear(x[b,c]):
//   grad_mask[b,g,k,p]   += grad_col * v
//   grad_offset[b,g,k,p] += grad_col * m * (dv/dy, dv/dx)   (the analytic
//                           dmcn_get_coordinate_weight form, same corner rule)
//   grad_x[b,c,corner]   += grad_col * m * corner weight   (4 corners)
// All three accumulate with fp32 atomics into fp32 scratch that the
// wrapper zeroes and casts: a group's channels can span threads, and x
// corners are shared between pixels. bf16 atomics would lose the sum.
//
// K3, per block = (64 out-channels x 64 in-channels, tap k) over a strided
// set of pixel tiles:
//   grad_W[o,c,k] = sum_{b,p} grad_out[b,o,p] * col[b,c,k,p]
// col is recomputed on the fly in shared memory (never saved), partial sums
// stay in registers and land with one fp32 atomic per element per block.
//
// What bounds them on the H100: both read x, offset, mask and grad_out and
// do the same 2*B*HW*C*Cout*9 FLOP as the forward; this first version does
// that contraction with fp32 FMAs on the CUDA cores, so it is bound by
// those operations, and K2 additionally by its 4 atomics per (c, k, p)
// into grad_x. wgmma and a gather-side grad_x are for a later version.
#include <algorithm>

#include "dcn_common.cuh"

namespace dcn {

// wt2: weight transposed to (9, Cout, C) so a tile load is coalesced.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_data_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                    const T* __restrict__ mask, const T* __restrict__ wt2,
                    const T* __restrict__ gout, float* __restrict__ gx,
                    float* __restrict__ goff, float* __restrict__ gmask, int C, int H, int W,
                    int Cout, int gd, int tiles_per_frame) {
  __shared__ float gos[kTileO * kTileP];
  __shared__ float wsm[kTileO * kTileC];
  __shared__ float gcol[kTileC * kTileP];

  const int hw = H * W, cg = C / gd, gk = gd * kTaps;
  const int b = blockIdx.x / tiles_per_frame;
  const int p0 = (blockIdx.x % tiles_per_frame) * kTileP;
  const int c0 = blockIdx.y * kTileC;
  const int tp = threadIdx.x % 16, tc = threadIdx.x / 16;
  const int pl = threadIdx.x % kTileP, cq = threadIdx.x / kTileP;
  const int pix = p0 + pl;

  for (int k = 0; k < kTaps; ++k) {
    // grad_col tile for tap k: (64 c) x (64 p), 4 c x 4 p per thread.
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int o0 = 0; o0 < Cout; o0 += kTileO) {
      for (int e = threadIdx.x; e < kTileO * kTileP; e += kThreads) {
        const int ol = e / kTileP, q = e % kTileP;
        const int o = o0 + ol, px = p0 + q;
        gos[e] = (o < Cout && px < hw) ? ld(gout + ((int64_t)b * Cout + o) * hw + px) : 0.f;
      }
      for (int e = threadIdx.x; e < kTileO * kTileC; e += kThreads) {
        const int ol = e / kTileC, cl = e % kTileC;
        const int o = o0 + ol, c = c0 + cl;
        wsm[e] = (o < Cout && c < C) ? ld(wt2 + ((int64_t)k * Cout + o) * C + c) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int ol = 0; ol < kTileO; ++ol) {
        float g[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = gos[ol * kTileP + tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = wsm[ol * kTileC + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(g[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gcol[(tc + 16 * j) * kTileP + tp + 16 * i] = acc[i][j];
    __syncthreads();

    // Scatter: thread owns pixel pl and channels [16*cq, 16*cq+16).
    if (pix < hw) {
      int last_g = -1;
      Sample s;
      float m = 0.f, pm = 0.f, py = 0.f, px = 0.f;
      for (int j = 0; j < 16; ++j) {
        const int cl = cq * 16 + j, c = c0 + cl;
        if (c >= C) break;
        const int g = c / cg;
        if (g != last_g) {
          if (last_g >= 0) {
            const int64_t ch = (int64_t)b * gk + last_g * kTaps + k;
            if (gmask) atomicAdd(gmask + ch * hw + pix, pm);
            atomicAdd(goff + (2 * ch) * hw + pix, py);
            atomicAdd(goff + (2 * ch + 1) * hw + pix, px);
          }
          s = sample_at(offset, mask, b, g, k, pix, H, W, gk, &m);
          last_g = g;
          pm = py = px = 0.f;
        }
        const float gc = gcol[cl * kTileP + pl];
        const int64_t plane = ((int64_t)b * C + c) * hw;
        float v[4];
        corners(x + plane, s, v);
        const float hy = 1.f - s.ly, hx = 1.f - s.lx;
        pm += gc * bilinear(s, v);
        const float gm = gc * m;
        py += gm * (hx * (v[2] - v[0]) + s.lx * (v[3] - v[1]));
        px += gm * (hy * (v[1] - v[0]) + s.ly * (v[3] - v[2]));
        if (s.i00 >= 0) atomicAdd(gx + plane + s.i00, gm * hy * hx);
        if (s.i01 >= 0) atomicAdd(gx + plane + s.i01, gm * hy * s.lx);
        if (s.i10 >= 0) atomicAdd(gx + plane + s.i10, gm * s.ly * hx);
        if (s.i11 >= 0) atomicAdd(gx + plane + s.i11, gm * s.ly * s.lx);
      }
      if (last_g >= 0) {
        const int64_t ch = (int64_t)b * gk + last_g * kTaps + k;
        if (gmask) atomicAdd(gmask + ch * hw + pix, pm);
        atomicAdd(goff + (2 * ch) * hw + pix, py);
        atomicAdd(goff + (2 * ch + 1) * hw + pix, px);
      }
    }
    __syncthreads();
  }
}

constexpr int kLd = kTileP + 1;  // padded row: conflict-free column reads

template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_weight_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                      const T* __restrict__ mask, const T* __restrict__ gout,
                      float* __restrict__ gw, int B, int C, int H, int W, int Cout, int gd,
                      int tiles_per_frame, int c_tiles) {
  __shared__ float col[kTileC * kLd];
  __shared__ float gos[kTileO * kLd];

  const int hw = H * W;
  const int k = blockIdx.z;
  const int c0 = (blockIdx.y % c_tiles) * kTileC;
  const int o0 = (blockIdx.y / c_tiles) * kTileO;
  const int tc = threadIdx.x % 16, to = threadIdx.x / 16;
  const int n_tiles = B * tiles_per_frame;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_frame;
    const int p0 = (t % tiles_per_frame) * kTileP;
    fill_columns(col, kLd, x, offset, mask, b, k, c0, p0, C, H, W, gd);
    for (int e = threadIdx.x; e < kTileO * kTileP; e += kThreads) {
      const int ol = e / kTileP, q = e % kTileP;
      const int o = o0 + ol, px = p0 + q;
      gos[ol * kLd + q] =
          (o < Cout && px < hw) ? ld(gout + ((int64_t)b * Cout + o) * hw + px) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < kTileP; ++q) {
      float g[4], a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = gos[(to + 16 * i) * kLd + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = col[(tc + 16 * j) * kLd + q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(g[i], a[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + to + 16 * i;
    if (o >= Cout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc + 16 * j;
      if (c < C) atomicAdd(gw + ((int64_t)o * C + c) * kTaps + k, acc[i][j]);
    }
  }
}

template <typename T>
static int launch_data(const void* x, const void* offset, const void* mask, const void* wt2,
                       const void* gout, void* gx, void* goff, void* gmask, int B, int C,
                       int H, int W, int Cout, int gd, cudaStream_t stream) {
  const int tpf = (H * W + kTileP - 1) / kTileP;
  dim3 grid(B * tpf, (C + kTileC - 1) / kTileC);
  dcn_bwd_data_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)offset, (const T*)mask, (const T*)wt2, (const T*)gout,
      (float*)gx, (float*)goff, (float*)gmask, C, H, W, Cout, gd, tpf);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_weight(const void* x, const void* offset, const void* mask,
                         const void* gout, void* gw, int B, int C, int H, int W, int Cout,
                         int gd, cudaStream_t stream) {
  const int tpf = (H * W + kTileP - 1) / kTileP;
  const int c_tiles = (C + kTileC - 1) / kTileC;
  const int o_tiles = (Cout + kTileO - 1) / kTileO;
  // Blocks that share the pixel tiles of one (out, in, tap) weight tile:
  // enough for about four waves of the card's SMs, at most one per tile.
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int weight_tiles = kTaps * c_tiles * o_tiles;
  const int n_split =
      std::max(1, std::min(B * tpf, (4 * sms + weight_tiles - 1) / weight_tiles));
  dim3 grid(n_split, c_tiles * o_tiles, kTaps);
  dcn_bwd_weight_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)offset, (const T*)mask, (const T*)gout, (float*)gw, B, C, H, W,
      Cout, gd, tpf, c_tiles);
  return (int)cudaGetLastError();
}

}  // namespace dcn

// dtype: 0 = float32, 1 = bfloat16 for x, offset, mask, wt2 and grad_out.
// gx (B,C,H,W), goff (B,2*Gd*9,H,W), gmask (B,Gd*9,H,W) are zeroed fp32
// scratch; mask and gmask may be null. Returns cudaGetLastError().
extern "C" int dcn_bwd_data(const void* x, const void* offset, const void* mask,
                            const void* wt2, const void* gout, void* gx, void* goff,
                            void* gmask, int B, int C, int H, int W, int Cout, int gd,
                            int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dcn::launch_data<float>(x, offset, mask, wt2, gout, gx, goff, gmask, B, C, H, W,
                                   Cout, gd, s);
  if (dtype == 1)
    return dcn::launch_data<__nv_bfloat16>(x, offset, mask, wt2, gout, gx, goff, gmask, B,
                                           C, H, W, Cout, gd, s);
  return (int)cudaErrorInvalidValue;
}

// gw (Cout, C, 3, 3) is zeroed fp32 scratch.
extern "C" int dcn_bwd_weight(const void* x, const void* offset, const void* mask,
                              const void* gout, void* gw, int B, int C, int H, int W,
                              int Cout, int gd, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dcn::launch_weight<float>(x, offset, mask, gout, gw, B, C, H, W, Cout, gd, s);
  if (dtype == 1)
    return dcn::launch_weight<__nv_bfloat16>(x, offset, mask, gout, gw, B, C, H, W, Cout,
                                             gd, s);
  return (int)cudaErrorInvalidValue;
}
