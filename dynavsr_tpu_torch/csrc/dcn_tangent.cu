// K8 dcn_fwd_tangent, K9 dcn_bwd_weight_tangent, K10 dcn_bwd_data_tangent:
// the terms of the DCN's second order along an offset cotangent, fp32, for
// sm_90a.
//
// Replaces: the second-order VJP that JAX's autodiff takes of
// dynavsr_tpu/ops/dcn_fused.py:deform_conv2d_fused when meta-training
// differentiates through the inner step (dynavsr_tpu/train/meta.py:60-62,
// first_order false). A double backward through the DCN is K1-K3 run
// again on other inputs (ops/dcn.py: DcnBwdDataFunction,
// DcnBwdWeightFunction), plus the terms along the cotangent coff of K2's
// offset gradient, which need the derivative of the bilinear sample along
// coff. With the tangent columns
//
//   tcol[b,c,k,p] = m[b,g,k,p] * sum_corners x[b,c,corner] * tw_corner,
//   tw_corner     = coff_y * d w_corner / dy + coff_x * d w_corner / dx,
//
// and gc = W^T . grad_out (the column gradients):
//   K8  out[b,o,p]     = sum_{c,k} W[o,c,k] tcol[b,c,k,p]
//   K9  gw[o,c,k]      = sum_{b,p} grad_out[b,o,p] tcol[b,c,k,p]
//   K10 gx[b,c,corner] += gc m tw_corner  (for every sample and corner)
//       goff_y[b,g,k,p] = sum_{c in g} gc m h coff_x,
//       goff_x[b,g,k,p] = sum_{c in g} gc m h coff_y,
//       h = x00 - x01 - x10 + x11 (d2 bilinear / dy dx, the only nonzero
//       second derivative of a bilinear sample)
//       gmask[b,g,k,p]  = sum_{c in g} gc * sum_corners x tw_corner
// (plain versions: ops/dcn_ref.py, dcn_*_tangent_ref).
//
// What bounds them on the H100 (80GB HBM3, 700 W): the meta inner step runs
// PCD on 40 frames of SLR 16x16, 8x8 and 4x4 with C = Cout = 64, Gd 8. At
// 16x16 each kernel's product is 0.38 G FMA (11 us at 67 TFLOP/s fp32, TF32
// off) and its bytes a few MB (~2 us at 3.35 TB/s): operations bound them.
// These are small calls, so what the card spends is the sample chains
// (offsets -> positions -> corners) and, for K9 / K10, their atomics.
//
// Design: a simple kernel that is right first. Shared with K1-K3
// (dcn_common.cuh): x is read channels-last, so the 32 channels of a chunk
// at one corner are one coalesced 128-byte read; a sample's corners are
// taken at the clamped positions of `position` with weight 0 outside, so
// every load is unconditional. The products are plain fp32 FMAs over tiles
// in shared memory (32 pixels x 32 channels of columns, 64 output channels):
//  - K8: a block owns 32 pixels of one frame and 64 output channels and
//    walks (tap, 32-channel chunk) steps: the tangent column tile and the
//    weight slice go to shared memory, then each thread accumulates 8
//    pixels x 1 output channel.
//  - K9: a block owns one (tap, 32-channel chunk, 64 output channels) slice
//    of gw and walks 8 pixel tiles, each thread summing 8 channels x 1
//    output channel in registers; one atomicAdd per entry at the end.
//  - K10: a block owns 32 pixels, one tap and 32 channels: gc is a product
//    over Cout in shared memory (each thread 4 pixels x 1 channel), then
//    each thread scatters its grad x with atomics (channels-last, so a
//    warp's 32 atomics are consecutive addresses), and the offset and mask
//    terms are summed over the group's channels by warp shuffles (lanes are
//    consecutive channels) before one atomicAdd a group.
// fp32 only: the meta configs run fp32; a bf16 call raises in the wrapper.
#include <stdint.h>

#include <algorithm>

#include "dcn_common.cuh"

namespace dcn {
namespace tng {

constexpr int kTP = 32;   // pixels per tile
constexpr int kTC = 32;   // channels per chunk (one warp's lanes)
constexpr int kTO = 64;   // output channels per block or product step
constexpr int kTT = 256;  // threads per block
constexpr int kRows = kTT / kTC;  // 8 warps: a warp's lanes are the chunk's channels

// The corners of one sample and their tangent weights.
struct Tan {
  int idx[4];     // clamped pixel index of each corner in its plane
  float tw[4];    // coff . d w / d pos, 0 outside the frame
  float sh[4];    // sign of the corner in h, 0 outside the frame
  bool in[4];
};

__device__ __forceinline__ Tan tangent_at(int pix, int k, float dy, float dx, float cy, float cx,
                                          int H, int W) {
  Pre p;  // one round: dcn_common.cuh's clamped position
  p.by[0] = (float)(pix / W - 1 + k / 3);
  p.bx[0] = (float)(pix % W - 1 + k % 3);
  p.dy[0] = dy;
  p.dx[0] = dx;
  p.on = 1u;
  const Pos q = position(p, 0, H, W);
  const float hy = 1.f - q.ly, hx = 1.f - q.lx;
  const float wy[4] = {-hx, -q.lx, hx, q.lx};   // d w / dy: 00, 01, 10, 11
  const float wx[4] = {-hy, hy, -q.ly, q.ly};   // d w / dx
  const float sg[4] = {1.f, -1.f, -1.f, 1.f};
  const bool in[4] = {q.y0in && q.x0in, q.y0in && q.x1in, q.y1in && q.x0in, q.y1in && q.x1in};
  Tan t;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    t.idx[c] = q.idx[c];
    t.in[c] = in[c];
    t.tw[c] = in[c] ? cy * wy[c] + cx * wx[c] : 0.f;
    t.sh[c] = in[c] ? sg[c] : 0.f;
  }
  return t;
}

// The inputs of one (frame, group, tap, pixel) sample.
struct Sample {
  float dy, dx, cy, cx, m;
};

__device__ __forceinline__ Sample load_sample(const float* offset, const float* mask,
                                              const float* coff, int b, int g, int k, int pix,
                                              int gk, int hw) {
  const int64_t och = ((int64_t)b * 2 * gk + 2 * (g * kTaps + k)) * hw + pix;
  Sample s;
  s.dy = offset[och];
  s.dx = offset[och + hw];
  s.cy = coff[och];
  s.cx = coff[och + hw];
  s.m = mask ? mask[((int64_t)b * gk + g * kTaps + k) * hw + pix] : 1.f;
  return s;
}

// One tangent column value; xb is x (channels-last) at frame b, channel c.
__device__ __forceinline__ float tangent_col(const float* xb, const float* offset,
                                             const float* mask, const float* coff, int b, int g,
                                             int k, int pix, int C, int H, int W, int gk) {
  const Sample s = load_sample(offset, mask, coff, b, g, k, pix, gk, H * W);
  const Tan t = tangent_at(pix, k, s.dy, s.dx, s.cy, s.cx, H, W);
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) v = fmaf(__ldg(xb + (int64_t)t.idx[c] * C), t.tw[c], v);
  return s.m * v;
}

// Fill the (32 channels x 32 pixels) tangent column tile of tap k, chunk
// c0, pixel tile p0 of frame b: lane = channel, warp = pixel row.
__device__ __forceinline__ void column_tile(float (*col)[kTP + 1], const float* x,
                                            const float* offset, const float* mask,
                                            const float* coff, int b, int p0, int k, int c0,
                                            int C, int H, int W, int gd) {
  const int hw = H * W, cg = C / gd, lane = threadIdx.x % kTC, row = threadIdx.x / kTC;
  const int c = c0 + lane;
  const float* xb = x + (int64_t)b * hw * C + (c < C ? c : 0);
#pragma unroll
  for (int i = 0; i < kTP / kRows; ++i) {
    const int px = row + kRows * i, pix = p0 + px;
    col[lane][px] = (c < C && pix < hw)
                        ? tangent_col(xb, offset, mask, coff, b, c / cg, k, pix, C, H, W,
                                      gd * kTaps)
                        : 0.f;
  }
}

// K8. Grid (B * tiles a frame, ceil(Cout / 64)). wt: (9, C, Cout).
__global__ void __launch_bounds__(kTT)
dcn_fwd_tangent_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                       const float* __restrict__ mask, const float* __restrict__ coff,
                       const float* __restrict__ wt, float* __restrict__ out, int C, int H, int W,
                       int Cout, int gd, int tpf) {
  __shared__ float col[kTC][kTP + 1];
  __shared__ float ws[kTC][kTO];
  const int hw = H * W, b = blockIdx.x / tpf, p0 = (blockIdx.x % tpf) * kTP;
  const int o0 = blockIdx.y * kTO, oo = threadIdx.x % kTO, pg = threadIdx.x / kTO;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int k = 0; k < kTaps; ++k) {
    for (int c0 = 0; c0 < C; c0 += kTC) {
      column_tile(col, x, offset, mask, coff, b, p0, k, c0, C, H, W, gd);
      for (int e = threadIdx.x; e < kTC * kTO; e += kTT) {
        const int cc = e / kTO, o = e % kTO;
        ws[cc][o] = (c0 + cc < C && o0 + o < Cout)
                        ? wt[((int64_t)k * C + c0 + cc) * Cout + o0 + o] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < kTC; ++cc) {
        const float w = ws[cc][oo];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(col[cc][pg * 8 + j], w, acc[j]);
      }
      __syncthreads();
    }
  }
  const int o = o0 + oo;
  if (o >= Cout) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int pix = p0 + pg * 8 + j;
    if (pix < hw) out[((int64_t)b * Cout + o) * hw + pix] = acc[j];
  }
}

// K9. Grid (blocks over pixel tiles, 9 * nch, ceil(Cout / 64)); gw (Cout,
// C, 3, 3) fp32, zeroed by the launcher.
__global__ void __launch_bounds__(kTT)
dcn_bwd_weight_tangent_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                              const float* __restrict__ mask, const float* __restrict__ coff,
                              const float* __restrict__ grad_out, float* __restrict__ gw, int C,
                              int H, int W, int Cout, int gd, int tpf, int ntiles, int nch) {
  __shared__ float col[kTC][kTP + 1];
  __shared__ float gos[kTO][kTP + 1];
  const int hw = H * W, k = blockIdx.y / nch, c0 = (blockIdx.y % nch) * kTC;
  const int o0 = blockIdx.z * kTO, oo = threadIdx.x % kTO, cgp = threadIdx.x / kTO;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tpf, p0 = (tile % tpf) * kTP;
    column_tile(col, x, offset, mask, coff, b, p0, k, c0, C, H, W, gd);
    for (int e = threadIdx.x; e < kTO * kTP; e += kTT) {
      const int o = e / kTP, px = e % kTP;
      gos[o][px] = (o0 + o < Cout && p0 + px < hw)
                       ? grad_out[((int64_t)b * Cout + o0 + o) * hw + p0 + px] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int px = 0; px < kTP; ++px) {
      const float g = gos[oo][px];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(g, col[cgp * 8 + j][px], acc[j]);
    }
    __syncthreads();
  }
  const int o = o0 + oo;
  if (o >= Cout) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + cgp * 8 + j;
    if (c < C) atomicAdd(gw + ((int64_t)o * C + c) * kTaps + k, acc[j]);
  }
}

// K10. Grid (B * tiles a frame, 9 * nch). wt: (9, Cout, C); gx channels-last
// (B, H, W, C), goff and gmask as offset and mask; all fp32, zeroed by the
// launcher. seg: the largest power of two dividing both the group size and
// 32 (a run of seg lanes lies in one group).
__global__ void __launch_bounds__(kTT)
dcn_bwd_data_tangent_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                            const float* __restrict__ mask, const float* __restrict__ coff,
                            const float* __restrict__ wt, const float* __restrict__ grad_out,
                            float* __restrict__ gx, float* __restrict__ goff,
                            float* __restrict__ gmask, int C, int H, int W, int Cout, int gd,
                            int tpf, int nch, int seg) {
  __shared__ float ws[kTO][kTC];
  __shared__ float gos[kTO][kTP];
  const int hw = H * W, cg = C / gd, gk = gd * kTaps;
  const int b = blockIdx.x / tpf, p0 = (blockIdx.x % tpf) * kTP;
  const int k = blockIdx.y / nch, c0 = (blockIdx.y % nch) * kTC;
  const int lane = threadIdx.x % kTC, row = threadIdx.x / kTC, c = c0 + lane;
  constexpr int kPer = kTP / kRows;  // pixels a thread: row, row + 8, ...
  float gc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) gc[i] = 0.f;
  for (int o0 = 0; o0 < Cout; o0 += kTO) {
    for (int e = threadIdx.x; e < kTO * kTC; e += kTT) {
      const int o = e / kTC, cc = e % kTC;
      ws[o][cc] = (o0 + o < Cout && c0 + cc < C)
                      ? wt[((int64_t)k * Cout + o0 + o) * C + c0 + cc] : 0.f;
    }
    for (int e = threadIdx.x; e < kTO * kTP; e += kTT) {
      const int o = e / kTP, px = e % kTP;
      gos[o][px] = (o0 + o < Cout && p0 + px < hw)
                       ? grad_out[((int64_t)b * Cout + o0 + o) * hw + p0 + px] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int o = 0; o < kTO; ++o) {
      const float w = ws[o][lane];
#pragma unroll
      for (int i = 0; i < kPer; ++i) gc[i] = fmaf(w, gos[o][row + kRows * i], gc[i]);
    }
    __syncthreads();
  }
  const float* xb = x + (int64_t)b * hw * C + (c < C ? c : 0);
  float* gxb = gx + (int64_t)b * hw * C + c;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int pix = p0 + row + kRows * i;  // the same pixel in every lane of the warp
    const bool valid = c < C && pix < hw;
    float poy = 0.f, pox = 0.f, pm = 0.f;
    const int g = valid ? c / cg : 0;
    if (valid) {
      const Sample s = load_sample(offset, mask, coff, b, g, k, pix, gk, hw);
      const Tan t = tangent_at(pix, k, s.dy, s.dx, s.cy, s.cx, H, W);
      const float gcm = gc[i] * s.m;
      float h = 0.f, d = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = __ldg(xb + (int64_t)t.idx[q] * C);
        h = fmaf(t.sh[q], v, h);
        d = fmaf(t.tw[q], v, d);
        if (t.in[q]) atomicAdd(gxb + (int64_t)t.idx[q] * C, gcm * t.tw[q]);
      }
      poy = gcm * h * s.cx;
      pox = gcm * h * s.cy;
      pm = gc[i] * d;
    }
    // Sum over the group's lanes (seg lanes at a time), then one atomic.
    for (int sh = seg / 2; sh > 0; sh >>= 1) {
      poy += __shfl_xor_sync(0xffffffffu, poy, sh);
      pox += __shfl_xor_sync(0xffffffffu, pox, sh);
      pm += __shfl_xor_sync(0xffffffffu, pm, sh);
    }
    if (valid && lane % seg == 0) {
      const int64_t och = ((int64_t)b * 2 * gk + 2 * (g * kTaps + k)) * hw + pix;
      atomicAdd(goff + och, poy);
      atomicAdd(goff + och + hw, pox);
      if (gmask) atomicAdd(gmask + ((int64_t)b * gk + g * kTaps + k) * hw + pix, pm);
    }
  }
}

}  // namespace tng
}  // namespace dcn

// All tensors fp32. x_cl: x channels-last (B, H, W, C); offset, coff (B,
// 2*Gd*9, H, W) and mask (B, Gd*9, H, W, or null) NCHW; wt (9, C, Cout);
// out (B, Cout, H, W). Returns cudaGetLastError() after the launch.
extern "C" int dcn_fwd_tangent(const void* x_cl, const void* offset, const void* mask,
                               const void* coff, const void* wt, void* out, int B, int C, int H,
                               int W, int Cout, int gd, void* stream) {
  using namespace dcn::tng;
  if (B == 0 || H * W == 0 || Cout == 0) return 0;
  const int tpf = (H * W + kTP - 1) / kTP;
  dcn_fwd_tangent_kernel<<<dim3(B * tpf, (Cout + kTO - 1) / kTO), kTT, 0, (cudaStream_t)stream>>>(
      (const float*)x_cl, (const float*)offset, (const float*)mask, (const float*)coff,
      (const float*)wt, (float*)out, C, H, W, Cout, gd, tpf);
  return (int)cudaGetLastError();
}

// grad_out (B, Cout, H, W); gw (Cout, C, 3, 3), zeroed here.
extern "C" int dcn_bwd_weight_tangent(const void* x_cl, const void* offset, const void* mask,
                                      const void* coff, const void* grad_out, void* gw, int B,
                                      int C, int H, int W, int Cout, int gd, void* stream) {
  using namespace dcn::tng;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(gw, 0, sizeof(float) * (size_t)Cout * C * dcn::kTaps, s);
  if (B == 0 || H * W == 0 || Cout == 0 || C == 0) return (int)cudaGetLastError();
  const int tpf = (H * W + kTP - 1) / kTP, ntiles = B * tpf, nch = (C + kTC - 1) / kTC;
  const int gx = std::max(1, (ntiles + 7) / 8);  // 8 pixel tiles a block
  dcn_bwd_weight_tangent_kernel<<<dim3(gx, dcn::kTaps * nch, (Cout + kTO - 1) / kTO), kTT, 0, s>>>(
      (const float*)x_cl, (const float*)offset, (const float*)mask, (const float*)coff,
      (const float*)grad_out, (float*)gw, C, H, W, Cout, gd, tpf, ntiles, nch);
  return (int)cudaGetLastError();
}

// wt (9, Cout, C); grad_out (B, Cout, H, W); gx_cl (B, H, W, C), goff as
// offset, gmask as mask (null without a mask): all zeroed here.
extern "C" int dcn_bwd_data_tangent(const void* x_cl, const void* offset, const void* mask,
                                    const void* coff, const void* wt, const void* grad_out,
                                    void* gx_cl, void* goff, void* gmask, int B, int C, int H,
                                    int W, int Cout, int gd, void* stream) {
  using namespace dcn::tng;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t px = (size_t)B * H * W;
  cudaMemsetAsync(gx_cl, 0, sizeof(float) * px * C, s);
  cudaMemsetAsync(goff, 0, sizeof(float) * px * 2 * gd * dcn::kTaps, s);
  if (gmask) cudaMemsetAsync(gmask, 0, sizeof(float) * px * gd * dcn::kTaps, s);
  if (px == 0 || C == 0) return (int)cudaGetLastError();
  const int tpf = (H * W + kTP - 1) / kTP, nch = (C + kTC - 1) / kTC, cg = C / gd;
  int seg = 1;
  while (seg < kTC && cg % (seg * 2) == 0) seg *= 2;
  dcn_bwd_data_tangent_kernel<<<dim3(B * tpf, dcn::kTaps * nch), kTT, 0, s>>>(
      (const float*)x_cl, (const float*)offset, (const float*)mask, (const float*)coff,
      (const float*)wt, (const float*)grad_out, (float*)gx_cl, (float*)goff, (float*)gmask, C,
      H, W, Cout, gd, tpf, nch, seg);
  return (int)cudaGetLastError();
}
