// K3's kernel body (dcn_bwd.cu's notes give its design), shared by K3
// dcn_bwd_weight and, with the tangent weight rule (kTan), by K9
// dcn_bwd_weight_tangent (dcn_tangent.cu): the same contraction
//   grad_W[o,c,k] = sum_{b,p} g[b,o,p] * col[b,c,k,p]
// over K1's columns (K3) or K8's tangent columns (K9).
//
// A block owns one (tap, 64 out-channel, 64 channel) tile of grad_W and
// walks pixel tiles x, x + gridDim.x, ... Each tile: the grad_out tile
// (64 o x 128 px) by cp.async, the column tile by gather_step, then the
// product into a register tile; one flush a block with vector atomics into
// a (9, Cout, C) fp32 scratch. Tiles of 128 pixels are tpf tiles of each
// frame (K3: `geo` is tpf) or walk the flattened (frame, pixel) index with
// frames `geo` pixels apart (K9, as K8; dcn_common.cuh: tile_at), so the
// meta inner step's 8x8 and 4x4 frames fill whole tiles.
#pragma once

#include <stdint.h>

#include "dcn_common.cuh"

namespace dcn {
namespace bwd {

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" : : "r"(d), "l"(src));
}

// grad_out rows [o0, o0 + 64) (zero past Cout) at the 128 pixels of `tile`:
//  bf16: [64 o][128 p], 16-byte chunk j of row o at j ^ (o & 7);
//  fp32: [64 o][128 p], 4-pixel group q of row o at col_px (as K1's fp32
//  column tile, with o for the channel).
// kFlat: each 16-byte chunk (4 pixels in fp32, 8 in bf16) comes from its
// own frame's plane, frames `geo` pixels apart (a multiple of the chunk's
// pixels, so a chunk never straddles two); pixels in a frame's padding or
// past the last of the B frames are zeros. Otherwise the tile is tile % geo
// of frame tile / geo.
template <bool kFlat, typename T>
__device__ __forceinline__ void load_gtile(T* dst, const T* gout, int tile, int geo, int B,
                                           int o0, int Cout, int hw, bool vec) {
  constexpr int kE = 16 / (int)sizeof(T), kChunks = kP / kE;
  int b = tile / geo;
  const int p0 = (tile - b * geo) * kP;
  for (int e = threadIdx.x; e < kN * kChunks; e += kThreads) {
    const int o = e / kChunks, j = e % kChunks;
    int p = p0 + j * kE;
    bool in = o0 + o < Cout;
    if constexpr (kFlat) {
      const int f = tile * kP + j * kE;
      b = f / geo;
      p = f - b * geo;
      in = in && b < B;
    }
    const int n = in ? max(0, min(kE, hw - p)) : 0;
    T* d = dst + o * kP;
    if constexpr (sizeof(T) == 2) d += (j ^ (o & 7)) << 3;
    else d += col_px(j * kE, o);
    const T* src = gout + ((int64_t)b * Cout + o0 + o) * hw + p;
    if (vec && n == kE) {
      cp16(d, src);
    } else {
      for (int i = 0; i < kE; ++i) st(d + i, i < n ? ld(src + i) : 0.f);
    }
  }
}

// The product, round r: pixels [32 r, 32 r + 32) of the tile, into the
// 64 x 64 (o, c) partial sums of one tap.
//  bf16: warp w owns out-channels 16 (w % 4) .. +16 and channels 32 (w / 4)
//  .. +32: 4 m16n8k16 tiles, acc[ni * 4 + e]; B = the column tile
//  ([p][64 c]) through ldmatrix.trans.
__device__ __forceinline__ void contract_w(const __nv_bfloat16* gt, const __nv_bfloat16* col,
                                           int r, float (&acc)[16]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = (warp & 3) * 16, c0 = (warp >> 2) * 32;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int kk = r * 2 + ks;  // k16 slice: pixels 16 kk .. +16
    uint32_t a[4], b[2][4];
    const int o = o0 + (lane & 15), ja = kk * 2 + (lane >> 4);
    ldmatrix_x4(a, gt + o * kP + ((ja ^ (o & 7)) << 3));
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int p = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
      const int j = (c0 + nb * 16) / 8 + (lane >> 4);
      ldmatrix_x4_trans(b[nb], col + p * kCK + ((j ^ (p & 7)) << 3));
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_bf16(acc + ni * 4, a, b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
  }
}
//  fp32: thread t owns out-channels 4 (t / 16) + {0..3} and channels
//  w_chan(t) + {0..3}, acc[i * 4 + j]; each read is a float4 of 4 pixels.
__device__ __forceinline__ int w_chan() {  // conflict-free: 8 lanes, 8 swizzles
  const int tc = threadIdx.x & 15;
  return 8 * (tc & 7) + 4 * (tc >> 3);
}
__device__ __forceinline__ void contract_w(const float* gt, const float* col, int r,
                                           float (&acc)[16]) {
  const int ob = (threadIdx.x >> 4) * 4, cb = w_chan();
#pragma unroll
  for (int pg = 0; pg < 8; ++pg) {
    const int p = (r * 8 + pg) * 4;
    float4 c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = *reinterpret_cast<const float4*>(col + (cb + j) * kP + col_px(p, cb + j));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 g = *reinterpret_cast<const float4*>(gt + (ob + i) * kP + col_px(p, ob + i));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i * 4 + j] = fmaf(g.w, c[j].w, fmaf(g.z, c[j].z, fmaf(g.y, c[j].y,
                              fmaf(g.x, c[j].x, acc[i * 4 + j]))));
    }
  }
}

// One tap's partial sums into the (9, Cout, C) fp32 scratch: vector
// atomics along c where every row is whole (kVec: C % 8 == 0).
template <typename T, bool kVec>
__device__ __forceinline__ void flush_w(const float (&acc)[16], float* gw, int k, int o0, int c0,
                                        int C, int Cout) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + (warp & 3) * 16 + (lane >> 2) + h * 8;
        const int c = c0 + (warp >> 2) * 32 + ni * 8 + (lane & 3) * 2;
        if (o >= Cout) continue;
        float* dst = gw + ((int64_t)k * Cout + o) * C + c;
        const float v0 = acc[ni * 4 + h * 2], v1 = acc[ni * 4 + h * 2 + 1];
        if constexpr (kVec) {
          if (c < C) atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
        } else {
          if (c < C) atomicAdd(dst, v0);
          if (c + 1 < C) atomicAdd(dst + 1, v1);
        }
      }
  } else {
    const int ob = o0 + (threadIdx.x >> 4) * 4, c = c0 + w_chan();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ob + i >= Cout) continue;
      float* dst = gw + ((int64_t)k * Cout + ob + i) * C + c;
      if constexpr (kVec) {
        if (c < C)
          atomicAdd(reinterpret_cast<float4*>(dst),
                    make_float4(acc[i * 4], acc[i * 4 + 1], acc[i * 4 + 2], acc[i * 4 + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < C) atomicAdd(dst + j, acc[i * 4 + j]);
      }
    }
  }
}

// The kernel body, run by K3's dcn_bwd_weight_kernel and K9's
// dcn_bwd_weight_tangent_kernel (kThreads threads, at most 2 blocks an SM).
// Block (x, y): pixel tiles x, x + gridDim.x, ... of ntiles; y = (out-chunk,
// in-chunk, tap). Shared memory: the column tile (128 x 64) and the
// grad_out tile (64 x 128). x is channels-last; gw the (9, Cout, C) fp32
// scratch, zeroed before. kTan: the tangent rule along coff on flat tiles
// (`geo` the frames' stride: a multiple of 4 pixels in fp32, of 8 in bf16,
// load_gtile's chunk); otherwise per-frame tiles (`geo` tpf).
template <typename T, bool kVec, bool kTan>
__device__ __forceinline__ void bwd_weight_body(const T* __restrict__ x,
                                                const T* __restrict__ offset,
                                                const T* __restrict__ mask,
                                                const T* __restrict__ coff,
                                                const T* __restrict__ gout, float* __restrict__ gw,
                                                int B, int C, int H, int W, int Cout, int gd,
                                                int geo, int ntiles, int c_tiles, bool quads,
                                                bool gvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* col = reinterpret_cast<T*>(smem);
  T* gt = col + kP * kCK;
  const int k = blockIdx.y % kTaps, rest = blockIdx.y / kTaps;
  const int c0 = (rest % c_tiles) * kCK, o0 = (rest / c_tiles) * kN;
  const int hw = H * W, cg = C / gd, gk = gd * kTaps;
  const float inv_w = 1.f / (float)W;

  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile tl = tile_at<kTan>(tile, geo, B);
    __syncthreads();  // the last tile's product is done with gt and col
    load_gtile<kTan>(gt, gout, tile, geo, B, o0, Cout, hw, gvec);
    gather_step<T, kVec, kTan>(col, x, offset, mask, coff, tl, k, c0, C, H, W, inv_w, cg, gk,
                               quads, [](int) {});
    wait_copies();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) contract_w(gt, col, r, acc);
  }
  flush_w<T, kVec>(acc, gw, k, o0, c0, C, Cout);
}

// The (9, Cout, C) fp32 scratch written out as (Cout, C, 3, 3) in gw's
// dtype (the body of K3's and K9's write-out kernels).
template <typename T>
__device__ __forceinline__ void scratch_to_oihw(const float* __restrict__ s, T* __restrict__ gw,
                                                int Cout, int C) {
  const int n = Cout * C * kTaps;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int k = i % kTaps, oc = i / kTaps;  // oc = o * C + c
    st(gw + i, s[(int64_t)k * Cout * C + oc]);
  }
}

}  // namespace bwd
}  // namespace dcn
