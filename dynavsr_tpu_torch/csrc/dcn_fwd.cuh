// K1's kernel body (dcn_fwd.cu's notes give its design), shared by K1
// dcn_fwd and, with the tangent weight rule (dcn_common.cuh), by K8
// dcn_fwd_tangent (dcn_tangent.cu).
//
// A block owns 64 output channels and walks items x, x + gridDim.x, ...:
// item = (pixel tile, split), tile-major. A tile's steps (tap, 64-channel
// chunk) are cut into `nsplit` runs of `per` consecutive steps; in fp32
// split 0 sums its run into out and split s > 0 into part + (s - 1) n_out,
// in bf16 (more than one split) split s into part + s n_out, so no partial
// sum is rounded to bf16 before the ordered sum (K1: one split). part is
// fp32. Tiles of 128 pixels are tpf tiles of each frame (K1: `geo` is
// tpf) or walk the flattened (frame, pixel) index with frames `geo` pixels
// apart (K8; dcn_common.cuh: tile_at).
#pragma once

#include "dcn_common.cuh"

namespace dcn {
namespace fwd {

// Bias, and the finished tile out to NCHW in out's dtype (U: T, or fp32
// for K8's partial sums); T sets the accumulators' layout. kFlat: the tile
// may span frames (tile_at).
template <bool kFlat, typename T, typename U>
__device__ __forceinline__ void epilogue(float (&acc)[32], U* out, const T* bias, int tile,
                                         int geo, int B, int o0, int hw, int Cout) {
  const int b0 = kFlat ? tile * kP / geo : tile / geo;
  const int p0 = kFlat ? tile * kP - b0 * geo : (tile - b0 * geo) * kP;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    int p, o;
    acc_pos<T>(e, &p, &o);
    int b = b0, pix = p0 + p;
    if constexpr (kFlat) {
      b += pix / geo;
      pix -= (pix / geo) * geo;
    }
    const int oc = o0 + o;
    if ((!kFlat || b < B) && pix < hw && oc < Cout)
      st(out + ((int64_t)b * Cout + oc) * hw + pix, acc[e] + (bias ? ld(bias + oc) : 0.f));
    acc[e] = 0.f;
  }
}

// The kernel body, run by K1's dcn_fwd_kernel and K8's
// dcn_fwd_tangent_kernel (kThreads threads, at most 2 blocks an SM). One
// block: out-channels [64 y, 64 y + 64); items x, x + gridDim.x, ...
// Shared memory: the column ring (2 x 128 x 64) and the weight ring (2
// slices of 64 x 64), each filled one step ahead. x is channels-last.
// kTan: the tangent rule along coff, no bias.
template <typename T, bool kVec, bool kTan>
__device__ __forceinline__ void fwd_body(const T* __restrict__ x, const T* __restrict__ offset,
                                         const T* __restrict__ mask, const T* __restrict__ coff,
                                         const T* __restrict__ wt, const T* __restrict__ bias,
                                         T* __restrict__ out, float* __restrict__ part, int B,
                                         int C, int H, int W, int Cout, int gd, int geo,
                                         int nitems, int nch, int nsplit, int64_t n_out,
                                         bool quads) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* col = reinterpret_cast<T*>(smem);
  T* wsm = col + 2 * kP * kCK;
  const int nsp = kTan ? nsplit : 1;  // K1: one split
  const int cg = C / gd, gk = gd * kTaps, per = kTaps * nch / nsp;
  const int o0 = blockIdx.y * kN;
  const float inv_w = 1.f / (float)W;
  int item = blockIdx.x;
  if (item >= nitems) return;

  // Gather the column tile and the weight slice of step gs of tile tl into
  // ring slot `slot`, round by round, running between(r) after the corner
  // loads of round r (and in bf16 of round r + 1) are issued.
  auto gather = [&](int slot, Tile tl, int gs, auto&& between) {
    const int k = gs / nch, c0 = (gs % nch) * kCK;
    load_slice(wsm + slot * kCK * kN, wt, k, c0, o0, C, Cout);
    gather_step<T, kVec, kTan>(col + slot * kP * kCK, x, offset, mask, coff, tl, k, c0, C, H, W,
                               inv_w, cg, gk, quads, between);
    wait_copies();  // the weight slice, before the barrier that publishes it
  };

  Tile cur = tile_at<kTan>(item / nsp, geo, B);
  gather(0, cur, item % nsp * per, [](int) {});
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int s = 0, ring = 0;; ring ^= 1) {
    int nitem = item, ns = s + 1;
    if (ns == per) {
      ns = 0;
      nitem += gridDim.x;
    }
    const bool more = nitem < nitems;  // the same in every thread of the block
    const T* cs = col + ring * kP * kCK;
    const T* ws = wsm + ring * kCK * kN;
    auto product = [&](int r) { contract(cs, ws, r, acc); };
    const Tile nxt = nitem == item ? cur : tile_at<kTan>(nitem / nsp, geo, B);
    if (more) {
      gather(ring ^ 1, nxt, nitem % nsp * per + ns, product);
    } else {
#pragma unroll
      for (int r = 0; r < kRounds; ++r) product(r);
    }
    if (s == per - 1) {
      const int split = item % nsp;
      if (split == 0 && (sizeof(T) == 4 || nsp == 1))
        epilogue<kTan>(acc, out, bias, item / nsp, geo, B, o0, H * W, Cout);
      else  // fp32 partial sums (bf16: every split's, summed and rounded by sum_parts)
        epilogue<kTan>(acc, part + (split - (sizeof(T) == 4)) * n_out, bias, item / nsp, geo, B,
                       o0, H * W, Cout);
    }
    if (!more) break;
    __syncthreads();
    item = nitem;
    s = ns;
    cur = nxt;
  }
}

}  // namespace fwd
}  // namespace dcn
