// K2 dcn_bwd_data and K3 dcn_bwd_weight — the modulated deformable conv's
// backward, for sm_90a.
//
// Replaces: the JAX autodiff of dynavsr_tpu/ops/dcn_fused.py:
// deform_conv2d_fused (gather VJP -> scatter-add into x, analytic offset and
// mask gradients, the weight contraction's transpose). Adaptation takes
// this gradient on every step.
//
// K2, per 8 x 16-pixel tile and (tap k, 64-channel chunk) step:
//   grad_col[c,p] = sum_o W[o,c,k] * g[b,o,p]                (the product)
// then for each (c, p) with its group g and sample v = bilinear(x[b,c]):
//   grad_mask[b,g,k,p]  = sum_{c in g} grad_col * v
//   grad_offset[b,g,k,p] = sum_{c in g} grad_col * m * (dv/dy, dv/dx)
//   grad_x[b,c,corner] += grad_col * m * corner weight
// K3, per 128-pixel tile, the same columns as K1:
//   grad_W[o,c,k] = sum_{b,p} g[b,o,p] * col[b,c,k,p]
//
// What bounds them on the H100 (80GB HBM3, 700 W; chip_smoke.py, PERF.md).
// At EDVR's adaptation call (40 frames of 36x44, C = Cout = 64, Gd 8) each
// does 4.7 GFLOP (0.070 ms of fp32 FMAs at 67 TFLOP/s, 0.005 ms on the bf16
// tensor cores) and moves 44 MB (K3) or 79 MB (K2) in bf16, 0.013 / 0.024
// ms: fp32 is bound by its FMAs, bf16 by its bytes. What the card spends is
// neither. K3, like K1, is bound by the gather: 4.6 M (pixel, tap, group)
// samples of 4 corners each, every one a dependent chain of loads. K2 also
// owes grad x, a scatter of 4 corners a sample: as float4 atomics into L2
// (an earlier design) it took half of K2's time, at about the same L2
// rate per value whatever the vector width. K2 now gathers it instead, and
// is bound by the instructions of that gather and of the offset and mask
// gradients, and by the latency of the steps between its barriers.
//
// Design (K1's, dcn_common.cuh): x is read channels-last (the copy K1 made
// in the forward), 16 bytes per corner for 8 channels.
//  - Products: bf16 on the tensor cores (mma.sync.m16n8k16, fp32
//    accumulation; K2's A operand is its grad_out tile held pixel-major, K3
//    reads its columns, rounded to bf16 as the plain version with bf16
//    columns and JAX's kernel round them, through ldmatrix.trans); fp32 IEEE
//    FMAs, K2 with an 8 px x 4 ch register tile, K3 with a 4 x 4 (o, c)
//    tile, all fed by float4 reads.
//  - K2 walks (tile, tap group) items; a block loads the tile's grad_out
//    once an item, streams one weight slice a step with cp.async, and for
//    each step writes the tile's grad_col (fp32) and every tile pixel's
//    sample (fractional parts, mask, corner, near / far) to shared memory.
//    Thread t owns segment t % 8 (8 channels) of 4 pixels of a tile row.
//    For its own samples it loads the 4 corners (16-byte loads) and sums
//    grad offset and grad mask over its channels into a shared staging,
//    from which each group's sums land once, with coalesced plain stores in
//    the output dtype: no atomics. grad x is gathered: a sample is near
//    when its corner floor lies 0 or 1 below its tap's base in both axes,
//    so its corners are within one pixel of the base; the owner of a pixel
//    q takes from grad_col every near sample of the tile that has q as a
//    corner (3 x 6 candidates for a thread's 4 pixels) and keeps the sum in
//    registers across the item's taps, then adds it to a channels-last fp32
//    scratch with two float4 atomics. Far samples, and corners that land in
//    another tile, go to the scratch with atomics by their owner (at EDVR's
//    offsets about one corner in six). A small kernel zeroes the scratch
//    first and another transposes it to NCHW in x's dtype afterwards.
//    Tried and measured: float4 atomics for every corner with neighbouring
//    pixels' corners merged (an earlier design; atomics bound), grad x
//    privatised in shared memory (the H100 has no native shared fp32
//    atomic add: atomicAdd there is a compare-and-swap loop), a halo of
//    grad_col around the tile so that every near sample is gathered (1.5x
//    the product and a 240-pixel grad_out region: slower, and one block an
//    SM in fp32).
//  - K3 runs one (tap, 64 x 64 (o, c) tile) a block over a persistent walk
//    of pixel tiles, keeps its partial sums in registers and flushes them
//    once with vector atomics into a (9, Cout, C) fp32 scratch; a small
//    kernel zeroes it first and another writes it out as OIHW in x's
//    dtype. Holding three taps' sums a block (one grad_out tile for three
//    taps) was measured: it spilled in fp32 and gained nothing in bf16.
//  - Grid fill: K2 splits a tile's taps into 1, 3 or 9 items, whichever
//    gives the fewest rounds of items a block (each costing its taps plus
//    one): 3 at EDVR's 36x44 and 9x11 levels, 1 at 18x22; K3's nine taps
//    give it 9 blocks a tile.
// Shapes the vector path does not take (C or C / Gd not a multiple of 8;
// in K2 also groups neither dividing 64 nor a multiple of it, or a side
// past kMaxSide) run K3 with the element-by-element gather and K2 as one
// thread per (pixel, group, tap) with scalar atomics for grad x.
#include <stdint.h>

#include <algorithm>

#include "dcn_common.cuh"

namespace dcn {
namespace bwd {

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" : : "r"(d), "l"(src));
}

// grad_out rows [o0, o0 + 64) (zero past Cout) at the 128 pixels from p0:
//  bf16: [64 o][128 p], 16-byte chunk j of row o at j ^ (o & 7);
//  fp32: [64 o][128 p], 4-pixel group q of row o at col_px (as K1's fp32
//  column tile, with o for the channel).
template <typename T>
__device__ __forceinline__ void load_gtile(T* dst, const T* gout, int b, int p0, int o0,
                                           int Cout, int hw, bool vec) {
  constexpr int kE = 16 / (int)sizeof(T), kChunks = kP / kE;
  for (int e = threadIdx.x; e < kN * kChunks; e += kThreads) {
    const int o = e / kChunks, j = e % kChunks, p = p0 + j * kE;
    const int n = (o0 + o < Cout) ? max(0, min(kE, hw - p)) : 0;
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

// K3's product, round r: pixels [32 r, 32 r + 32) of the tile, into the
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

// K3. Block (x, y): pixel tiles x, x + gridDim.x, ...; y = (out-chunk,
// in-chunk, tap). Shared memory: the column tile (128 x 64) and the
// grad_out tile (64 x 128).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dcn_bwd_weight_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                      const T* __restrict__ mask, const T* __restrict__ gout,
                      float* __restrict__ gw, int C, int H, int W, int Cout, int gd, int tpf,
                      int ntiles, int c_tiles, bool quads, bool gvec) {
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
    const Tile tl = tile_at(tile, tpf);
    __syncthreads();  // the last tile's product is done with gt and col
    load_gtile(gt, gout, tl.b, (tile - tl.b * tpf) * kP, o0, Cout, hw, gvec);
    gather_step<T, kVec>(col, x, offset, mask, tl, k, c0, C, H, W, inv_w, cg, gk, quads,
                         [](int) {});
    wait_copies();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) contract_w(gt, col, r, acc);
  }
  flush_w<T, kVec>(acc, gw, k, o0, c0, C, Cout);
}

// K2's tile: kTH x kTW output pixels of one frame, 128 in all. grad x is
// gathered, not scattered: a contribution of sample p (pixel p, tap k) to
// its corner pixel q is taken by q's thread from the tile's grad_col in
// shared memory when p and q lie in the same tile and the sample is near
// (its corner floor at offset -1 or 0 from p + tap - 1 in both axes); p's
// thread adds every other contribution with atomics (far samples, corners
// in another tile). The grad_out tile is held pixel-major ([pixel][64 o]).
constexpr int kTH = 8, kTW = 16, kTP = kTH * kTW;
constexpr int kSlots = kCK / kSeg;  // groups of a chunk: at most 8
constexpr int kSP = kTP + 1;        // row stride of the offset / mask staging
static_assert(kTP * kSeg == 4 * kThreads, "a thread owns 4 pixels of one segment");

// Float offset of 4-channel chunk j of tile pixel m in the fp32 grad_col
// tile: chunk j sits at (j >> 1) + 8 (j & 1), so the first halves of the 8
// segments fill one 128-byte line and the second halves the next, then
// xor (m & 7) for the product's stores.
__device__ __forceinline__ int gc_off(int m, int j) {
  return m * kCK + ((((j >> 1) | ((j & 1) << 3)) ^ (m & 7)) << 2);
}

// A tile pixel's sample of one (group, tap): fractional parts, modulation
// and a packed word: its top-left corner (y0 + 4, x0 + 4: 14 bits each),
// bit 28 set when it is near, bits 29 / 30 the floors fy + 1 / fx + 1.
// kOut (0): the pixel lies outside the frame.
constexpr unsigned kOut = 0u, kNear = 1u << 28;
constexpr int kMaxSide = (1 << 14) - 6;  // frames up to this height and width
__device__ __forceinline__ bool near01(int f) { return (unsigned)(f + 1) <= 1u; }
__device__ __forceinline__ unsigned pack_pos(int y0, int x0, int fy, int fx) {
  const unsigned near = near01(fy) && near01(fx) ? kNear | (unsigned)(fy + 1) << 29 |
                                                       (unsigned)(fx + 1) << 30
                                                 : 0u;
  return (unsigned)(y0 + 4) | (unsigned)(x0 + 4) << 14 | near;
}
__device__ __forceinline__ int pos_y(unsigned u) { return (int)(u & 0x3fffu) - 4; }
__device__ __forceinline__ int pos_x(unsigned u) { return (int)(u >> 14 & 0x3fffu) - 4; }

// The entry of the sample at tile pixel (py, px) of tap k with offsets (dy,
// dx) and mask mm: (ly, lx, mm, packed word), the position as position().
__device__ __forceinline__ float4 entry(int py, int px, int k, float dy, float dx, float mm,
                                        int H, int W) {
  const int by = py - 1 + k / 3, bx = px - 1 + k % 3;
  const float ys = fminf(fmaxf((float)by + dy, -2.f), (float)(H + 1));
  const float xs = fminf(fmaxf((float)bx + dx, -2.f), (float)(W + 1));
  const float y0f = floorf(ys), x0f = floorf(xs);
  const int y0 = (int)y0f, x0 = (int)x0f;
  return make_float4(ys - y0f, xs - x0f, mm, __uint_as_float(pack_pos(y0, x0, y0 - by, x0 - bx)));
}

// fp32: the samples of tap k, groups [g0, g0 + nslots), at every tile
// pixel: prm[m * kSlots + s] = entry(...). Every load is issued before the
// first is used. (fp32 has no room for bf16's staging a step ahead: it
// would leave one block an SM.)
template <typename T>
__device__ __forceinline__ void load_params(float4* prm, const T* offset, const T* mask, int b,
                                            int ty0, int tx0, int k, int g0, int nslots, int H,
                                            int W, int gk) {
  constexpr int kPE = kSlots * kTP / kThreads;  // entries a thread: 4
  const int hw = H * W, n = nslots * kTP;
  float raw[kPE][3];
  bool in[kPE];
#pragma unroll
  for (int i = 0; i < kPE; ++i) {
    const int e = threadIdx.x + i * kThreads, s = e / kTP, m = e % kTP;
    const int py = ty0 + m / kTW, px = tx0 + m % kTW;
    in[i] = e < n && py < H && px < W;
    raw[i][0] = raw[i][1] = 0.f;
    raw[i][2] = 1.f;
    if (in[i]) {
      const int j = (g0 + s) * kTaps + k, pix = py * W + px;
      const T* op = offset + ((int64_t)b * 2 * gk + 2 * j) * hw + pix;
      raw[i][0] = ld(op);
      raw[i][1] = ld(op + hw);
      if (mask) raw[i][2] = ld(mask + ((int64_t)b * gk + j) * hw + pix);
    }
  }
#pragma unroll
  for (int i = 0; i < kPE; ++i) {
    const int e = threadIdx.x + i * kThreads, s = e / kTP, m = e % kTP;
    const int py = ty0 + m / kTW, px = tx0 + m % kTW;
    if (e < n)
      prm[m * kSlots + s] = in[i] ? entry(py, px, k, raw[i][0], raw[i][1], raw[i][2], H, W)
                                  : make_float4(0.f, 0.f, 0.f, __uint_as_float(kOut));
  }
}

// bf16: the step's offsets and masks reach shared memory a step ahead.
// fetch_params copies those of tap k, groups [g0, g0 + nslots), at the
// tile's pixels into raw[3][kSlots][kRS] (dy, dx, mask): pairs of pixels by
// 4-byte cp.async where the pair lies in the frame and the planes allow it
// (vec), else by plain loads; put_params turns them into prm.
constexpr int kRS = kTP + 2;  // raw row stride: the slots of a pixel in distinct banks
template <typename T>
__device__ __forceinline__ void fetch_params(T* raw, const T* offset, const T* mask, int b,
                                             int ty0, int tx0, int k, int g0, int nslots, int H,
                                             int W, int gk, bool vec) {
  const int hw = H * W;
  for (int e = threadIdx.x; e < 3 * nslots * kTP / 2; e += kThreads) {
    const int pp = e % (kTP / 2), s = e / (kTP / 2) % nslots, v = e / (kTP / 2) / nslots;
    const int m = pp * 2, py = ty0 + m / kTW, px = tx0 + m % kTW;
    if (v == 2 && !mask) continue;
    const int j = (g0 + s) * kTaps + k;
    T* dst = raw + (v * kSlots + s) * kRS + m;
    const T* src = (v < 2 ? offset + ((int64_t)b * 2 * gk + 2 * j + v) * hw
                          : mask + ((int64_t)b * gk + j) * hw) + py * W + px;
    if (vec && py < H && px + 1 < W) {
      const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" : : "r"(d), "l"(src));
    } else {
      st(dst, py < H && px < W ? ld(src) : 0.f);
      st(dst + 1, py < H && px + 1 < W ? ld(src + 1) : 0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void put_params(float4* prm, const T* raw, bool has_mask, int ty0,
                                           int tx0, int k, int nslots, int H, int W) {
  for (int e = threadIdx.x; e < nslots * kTP; e += kThreads) {
    const int s = e % nslots, m = e / nslots, py = ty0 + m / kTW, px = tx0 + m % kTW;
    prm[m * kSlots + s] =
        py < H && px < W
            ? entry(py, px, k, ld(raw + s * kRS + m), ld(raw + (kSlots + s) * kRS + m),
                    has_mask ? ld(raw + (2 * kSlots + s) * kRS + m) : 1.f, H, W)
            : make_float4(0.f, 0.f, 0.f, __uint_as_float(kOut));
  }
}

// The grad_out tile: gt[oc][pixel][64 o] for the noc 64-row out-chunks,
// zero outside the frame and past Cout; 16-byte chunk j of a pixel row at
// j ^ (pixel & 7) (bf16) or j ^ (pixel & 15) (fp32).
__device__ __forceinline__ int gt_off(const __nv_bfloat16*, int m, int o) {
  return m * kN + (((o >> 3) ^ (m & 7)) << 3) + (o & 7);
}
__device__ __forceinline__ int gt_off(const float*, int m, int o) {
  return m * kN + (((o >> 2) ^ (m & 15)) << 2) + (o & 3);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T>
__device__ __forceinline__ void load_gout(T* gt, const T* gout, int b, int ty0, int tx0, int noc,
                                          int Cout, int H, int W) {
  constexpr int kRB = 8;  // pairs a thread loads before it stores them
  const int hw = H * W, n = noc * (kN / 2) * kTP;
  for (int e0 = threadIdx.x; e0 < n; e0 += kRB * kThreads) {
    float v[kRB][2];
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const int e = e0 + i * kThreads, m = e % kTP, o = e / kTP * 2;
      const int y = ty0 + m / kTW, xq = tx0 + m % kTW;
      const bool in = e < n && y < H && xq < W;
      const T* src = gout + ((int64_t)b * Cout + o) * hw + (in ? y * W + xq : 0);
      v[i][0] = in && o < Cout ? ld(src) : 0.f;
      v[i][1] = in && o + 1 < Cout ? ld(src + hw) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const int e = e0 + i * kThreads, m = e % kTP, o = e / kTP * 2;
      T* dst = gt + (o / kN) * kTP * kN;
      if (e < n) st2(dst + gt_off(dst, m, o % kN), v[i][0], v[i][1]);
    }
  }
}

// K2's product for one (tap, 64-channel chunk): gcol[m][c] = sum_o W[o,c,k]
// g[o, tile pixel m], fp32 accumulation.
//  bf16: warp w owns m16 tiles w % 4 and w % 4 + 4 and
//  channels 32 (w / 4) .. +32; A = the grad_out tile's pixel rows
//  (ldmatrix), B = the weight slot [64 c][64 o] (b_frags).
__device__ __forceinline__ void tile_product(float* gcol, const __nv_bfloat16* gt,
                                             const __nv_bfloat16* ws, int noc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n0 = (warp >> 2) * 32;
  int m[2];
  float acc[2][16];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = ((warp & 3) + 4 * i) * 16 + (lane & 15);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
  }
  for (int oc = 0; oc < noc; ++oc) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      uint32_t a[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], gt + (oc * kTP + m[i]) * kN +
                              (((r * 2 + (lane >> 4)) ^ (m[i] & 7)) << 3));
      b_frags(bf, ws + oc * kN * kCK, n0, r);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[i] + ni * 4, a[i], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ((warp & 3) + 4 * i) * 16 + (lane >> 2) + 8 * h;
        const int n = n0 + ni * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(gcol + gc_off(row, n >> 2) + (n & 3)) =
            make_float2(acc[i][ni * 4 + 2 * h], acc[i][ni * 4 + 2 * h + 1]);
      }
}
//  fp32: thread t owns tile pixels (t % 16) + 16 i (i < 8) and channels
//  4 (t / 16) .. +4; every read is a float4 (4 o of a pixel, 4 c of an o).
__device__ __forceinline__ void tile_product(float* gcol, const float* gt, const float* ws,
                                             int noc) {
  constexpr int kMI = kTP / 16;
  const int tp = threadIdx.x & 15, to = threadIdx.x >> 4;
  float acc[kMI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int oc = 0; oc < noc; ++oc) {
    const float* g = gt + oc * kTP * kN;
    const float* w = ws + oc * kN * kCK + to * 4;
#pragma unroll 2
    for (int oq = 0; oq < kN / 4; ++oq) {
      float4 wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = *reinterpret_cast<const float4*>(w + (oq * 4 + j) * kCK);
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int m = tp + 16 * i;
        const float4 gv = *reinterpret_cast<const float4*>(g + m * kN + ((oq ^ (m & 15)) << 2));
        acc[i][0] = fmaf(gv.w, wv[3].x, fmaf(gv.z, wv[2].x, fmaf(gv.y, wv[1].x, fmaf(gv.x, wv[0].x, acc[i][0]))));
        acc[i][1] = fmaf(gv.w, wv[3].y, fmaf(gv.z, wv[2].y, fmaf(gv.y, wv[1].y, fmaf(gv.x, wv[0].y, acc[i][1]))));
        acc[i][2] = fmaf(gv.w, wv[3].z, fmaf(gv.z, wv[2].z, fmaf(gv.y, wv[1].z, fmaf(gv.x, wv[0].z, acc[i][2]))));
        acc[i][3] = fmaf(gv.w, wv[3].w, fmaf(gv.z, wv[2].w, fmaf(gv.y, wv[1].w, fmaf(gv.x, wv[0].w, acc[i][3]))));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMI; ++i)
    *reinterpret_cast<float4*>(gcol + gc_off(tp + 16 * i, to)) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The 8 grad_col values of segment seg at tile pixel m.
__device__ __forceinline__ void gcol8(float gc[kSeg], const float* gcol, int m, int seg) {
  const float4 a = *reinterpret_cast<const float4*>(gcol + gc_off(m, 2 * seg));
  const float4 b = *reinterpret_cast<const float4*>(gcol + gc_off(m, 2 * seg + 1));
  gc[0] = a.x, gc[1] = a.y, gc[2] = a.z, gc[3] = a.w;
  gc[4] = b.x, gc[5] = b.y, gc[6] = b.z, gc[7] = b.w;
}

// grad x at one corner of 8 channels: two float4 atomics into the scratch.
__device__ __forceinline__ void add_corner(float* gxb, int idx, int C, const float v[kSeg]) {
  float4* dst = reinterpret_cast<float4*>(gxb + (int64_t)idx * C);
  atomicAdd(dst, make_float4(v[0], v[1], v[2], v[3]));
  atomicAdd(dst + 1, make_float4(v[4], v[5], v[6], v[7]));
}

// One of a thread's own samples in flight: its corners (8 channels), its
// entry in prm, which corners lie in the frame (bit q; none for a sample
// that is off) and which of those its thread adds with atomics (bit q: the
// sample is far, or the corner lies in another tile).
template <typename T>
struct OUnit {
  uint4 v[4][kVecs<T>];
  float4 p;
  unsigned in, push;
};

// Corner pixel indices of a packed position, clamped into the frame.
__device__ __forceinline__ void corner_idx(int idx[4], unsigned pk, int H, int W) {
  const int y0 = pos_y(pk), x0 = pos_x(pk);
  const int ya = min(max(y0, 0), H - 1) * W, yb = min(max(y0 + 1, 0), H - 1) * W;
  const int xa = min(max(x0, 0), W - 1), xb = min(max(x0 + 1, 0), W - 1);
  idx[0] = ya + xa;
  idx[1] = ya + xb;
  idx[2] = yb + xa;
  idx[3] = yb + xb;
}

// ty0, tx0: the tile's corner.
template <typename T>
__device__ __forceinline__ void issue_own(OUnit<T>& u, float4 p, bool on, int ty0, int tx0,
                                          const T* xb, int C, int H, int W) {
  const unsigned pk = __float_as_uint(p.w);
  const int y0 = pos_y(pk), x0 = pos_x(pk);
  const bool y0in = y0 >= 0 && y0 < H, y1in = y0 + 1 >= 0 && y0 + 1 < H;
  const bool x0in = x0 >= 0 && x0 < W, x1in = x0 + 1 >= 0 && x0 + 1 < W;
  u.p = p;
  u.in = on ? (unsigned)(y0in && x0in) | (unsigned)(y0in && x1in) << 1 |
                  (unsigned)(y1in && x0in) << 2 | (unsigned)(y1in && x1in) << 3
            : 0u;
  unsigned keep = 0u;  // corners the tile's own threads gather
  if (pk & kNear) {
    const bool r0 = (unsigned)(y0 - ty0) < (unsigned)kTH, r1 = (unsigned)(y0 + 1 - ty0) < (unsigned)kTH;
    const bool c0 = (unsigned)(x0 - tx0) < (unsigned)kTW, c1 = (unsigned)(x0 + 1 - tx0) < (unsigned)kTW;
    keep = (unsigned)(r0 && c0) | (unsigned)(r0 && c1) << 1 | (unsigned)(r1 && c0) << 2 |
           (unsigned)(r1 && c1) << 3;
  }
  u.push = u.in & ~keep;
  Pos q;
  corner_idx(q.idx, pk, H, W);
  load_corners(u.v, q, xb, C);
#pragma unroll
  for (int c = 0; c < 4; ++c)  // a corner outside the frame reads as 0
#pragma unroll
    for (int i = 0; i < kVecs<T>; ++i)
      if (!(u.in >> c & 1u)) u.v[c][i] = make_uint4(0u, 0u, 0u, 0u);
}

// A sample's grad mask and grad offset shares, summed over its 8 channels
// into its segment's staging entries sg[0], sg[kSeg kSP], sg[2 kSeg kSP]
// (mask, dy, dx; stored, or added where the group began in an earlier
// chunk), and the atomics of its grad x that no gather takes.
template <typename T>
__device__ __forceinline__ void own(const OUnit<T>& u, const float gc[kSeg], float* gxb, int C,
                                    int H, int W, float* sg, bool fresh) {
  const float ly = u.p.x, lx = u.p.y, m = u.p.z, hy = 1.f - ly, hx = 1.f - lx;
  float s[3] = {0.f, 0.f, 0.f};  // sum gc v, sum gc dv/dy, sum gc dv/dx
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const float a0 = chan(u.v[0], j), a1 = chan(u.v[1], j);
    const float a2 = chan(u.v[2], j), a3 = chan(u.v[3], j);
    const float d01 = a1 - a0, d23 = a3 - a2;
    const float top = fmaf(lx, d01, a0), dy = fmaf(lx, d23, a2) - top;
    s[0] = fmaf(gc[j], fmaf(ly, dy, top), s[0]);
    s[1] = fmaf(gc[j], dy, s[1]);
    s[2] = fmaf(gc[j], fmaf(ly, d23 - d01, d01), s[2]);
  }
  s[1] *= m;
  s[2] *= m;
#pragma unroll
  for (int i = 0; i < 3; ++i) sg[i * kSeg * kSP] = fresh ? s[i] : sg[i * kSeg * kSP] + s[i];
  if (u.push) {
    const float w[4] = {hy * hx, hy * lx, ly * hx, ly * lx};
    int idx[4];
    corner_idx(idx, __float_as_uint(u.p.w), H, W);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!(u.push >> q & 1u)) continue;
      float v[kSeg];
#pragma unroll
      for (int j = 0; j < kSeg; ++j) v[j] = gc[j] * m * w[q];
      add_corner(gxb, idx[q], C, v);
    }
  }
}

// grad x of this thread's 4 pixels (tile row tr, columns tc .. tc + 3) and
// segment from the near samples of tap (ky, kx) in tile row tr - ky + dr:
// over dr < 3 and dc < 6 the pixels (tr - ky + dr, tc - kx + dc) are every
// tile pixel whose near sample can have one of the 4 as a corner. prm: this
// segment's group slot (stride kSlots).
__device__ __forceinline__ void pull(float (&acc)[4][kSeg], const float4* prm, const float* gcol,
                                     int tr, int tc, int seg, int ky, int kx, int dr) {
  const int pr = tr - ky + dr;
  if ((unsigned)pr >= (unsigned)kTH) return;
#pragma unroll
  for (int dc = 0; dc < 6; ++dc) {
    const int pc = tc - kx + dc;
    if ((unsigned)pc >= (unsigned)kTW) continue;
    const int m = pr * kTW + pc;
    const float4 p = prm[m * kSlots];
    const unsigned pk = __float_as_uint(p.w);
    // The sample's corner floors against its base (pixel - 1 + tap).
    const int fy = (int)(pk >> 29 & 1u) - 1, fx = (int)(pk >> 30 & 1u) - 1;
    const int a = 1 - dr - fy;  // the corner row that lands on this thread's row
    if (!(pk & kNear) || (unsigned)a > 1u) continue;
    const float wy = p.z * (a ? p.x : 1.f - p.x);
    float gc[kSeg];
    gcol8(gc, gcol, m, seg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < dc - 2 || i > dc) continue;  // static: pixel i's reach
      const int bq = i - dc + 1 - fx;      // the corner column that lands on pixel i
      if ((unsigned)bq > 1u) continue;
      const float w = wy * (bq ? p.y : 1.f - p.y);
#pragma unroll
      for (int j = 0; j < kSeg; ++j) acc[i][j] = fmaf(w, gc[j], acc[i][j]);
    }
  }
}

// The offset and mask gradients of the groups of one (tap k, chunk c0)
// step from the staging: a group's segments summed, one plain store a
// value (two pixels a store where the frame's width allows), consecutive
// threads on consecutive pixels of a tile row.
template <typename T>
__device__ __forceinline__ void store_sums(const float* stg, T* goff, T* gmask, int b, int ty0,
                                           int tx0, int k, int c0, int C, int cg, int gk, int H,
                                           int W) {
  constexpr int kPairs = kTP / 2, kStride = kThreads / kPairs;
  const int hw = H * W, g0 = c0 / cg;
  const int spg = cg <= kCK ? cg / kSeg : kSlots;        // segments a group holds here
  const int ngr = cg <= kCK ? min(kCK, C - c0) / cg : 1;  // groups of the chunk
  const int m = threadIdx.x % kPairs * 2, y = ty0 + m / kTW, xq = tx0 + m % kTW;
  if (y >= H || xq >= W) return;
  const bool two = xq + 1 < W, both = two && W % 2 == 0;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    if (v == 0 && !gmask) continue;
    for (int gi = threadIdx.x / kPairs; gi < ngr; gi += kStride) {
      const float* src = stg + (v * kSeg + gi * spg) * kSP + m;
      float s0 = 0.f, s1 = 0.f;
      for (int q = 0; q < spg; ++q) {
        s0 += src[q * kSP];
        s1 += src[q * kSP + 1];
      }
      const int64_t j = (int64_t)(g0 + gi) * kTaps + k;
      T* dst = (v == 0 ? gmask + ((int64_t)b * gk + j) * hw
                       : goff + ((int64_t)b * 2 * gk + 2 * j + v - 1) * hw) + y * W + xq;
      if (both) {
        st2(dst, s0, s1);
      } else {
        st(dst, s0);
        if (two) st(dst + 1, s1);
      }
    }
  }
}

// K2. Block: items x, x + gridDim.x, ... of (tile, tap group) with taps [kt
// g, kt g + kt), kt = 9 / ntg. Shared memory: the grad_out tile (noc x 128
// x 64), one weight slot (noc x 64 x 64), the tile's grad_col (128 x 64
// fp32), its samples (128 x 8 slots float4) and the staging of the offset
// and mask gradients (3 x 8 segments x 128 fp32). wt: bf16 (9, C, Cout), fp32
// (9, Cout, C). bf16 also stages the next step's raw offsets and masks (3
// x 8 x 130). Thread t owns segment t % 8 of the 4 pixels (t / 32, 4 (t /
// 8 % 4) ..): their samples' offset and mask gradients, and their grad x.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dcn_bwd_data_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                    const T* __restrict__ mask, const T* __restrict__ wt,
                    const T* __restrict__ gout, float* __restrict__ gx, T* __restrict__ goff,
                    T* __restrict__ gmask, int C, int H, int W, int Cout, int gd, int ntx,
                    int tpf, int nitems, int ntg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int noc = (Cout + kN - 1) / kN, nch = (C + kCK - 1) / kCK;
  T* gt = reinterpret_cast<T*>(smem);
  T* ws = gt + noc * kTP * kN;
  float* gcol = reinterpret_cast<float*>(ws + noc * kN * kCK);
  float4* prm = reinterpret_cast<float4*>(gcol + kTP * kCK);
  float* stg = reinterpret_cast<float*>(prm + kSlots * kTP);
  T* raw = reinterpret_cast<T*>(stg + 3 * kSeg * kSP);  // bf16 only
  constexpr bool kAhead = sizeof(T) == 2;  // bf16: samples staged a step ahead
  const bool pvec = W % 2 == 0 && (uintptr_t)offset % 4 == 0 && (uintptr_t)mask % 4 == 0;
  const int hw = H * W, cg = C / gd, gk = gd * kTaps;
  const int kt = kTaps / ntg, steps = kt * nch;
  const int seg = unit_seg(), quad = threadIdx.x / kSeg;
  const int tr = quad / (kTW / 4), tc = quad % (kTW / 4) * 4;

  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int tile = item / ntg, k0 = item % ntg * kt;
    const int b = tile / tpf, t = tile - b * tpf;
    const int ty0 = t / ntx * kTH, tx0 = t % ntx * kTW, qy = ty0 + tr;
    const int ns0 = cg <= kCK ? min(kCK, C) / cg : 1;
    __syncthreads();  // the last item is done with the grad_out tile and the weight slot
    if constexpr (kAhead) fetch_params(raw, offset, mask, b, ty0, tx0, k0, 0, ns0, H, W, gk, pvec);
    load_gout(gt, gout, b, ty0, tx0, noc, Cout, H, W);
    for (int oc = 0; oc < noc; ++oc)
      load_slice(ws + oc * kN * kCK, wt, k0, oc * kN, 0, Cout, C);
    if constexpr (kAhead) {
      wait_copies();
      __syncthreads();
      put_params(prm, raw, mask != nullptr, ty0, tx0, k0, ns0, H, W);
    }

    float gxa[4][kSeg];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kSeg; ++j) gxa[i][j] = 0.f;
    for (int gs = 0; gs < steps; ++gs) {
      const int k = k0 + gs / nch, cc = gs % nch, c0 = cc * kCK, cs = c0 + seg * kSeg;
      const int ky = k / 3, kx = k % 3;
      const int slot = cg <= kCK ? seg * kSeg / cg : 0;
      if constexpr (!kAhead)
        load_params(prm, offset, mask, b, ty0, tx0, k, c0 / cg,
                    cg <= kCK ? min(kCK, C - c0) / cg : 1, H, W, gk);
      wait_copies();  // this step's weight slot
      __syncthreads();
      tile_product(gcol, gt, ws, noc);
      __syncthreads();  // the tile's grad_col and samples are in; the slot is free
      const int kn = k0 + (gs + 1) / nch, cn = (gs + 1) % nch * kCK;
      const int nsn = cg <= kCK ? min(kCK, C - cn) / cg : 1;
      if (gs + 1 < steps) {
        for (int oc = 0; oc < noc; ++oc)
          load_slice(ws + oc * kN * kCK, wt, kn, oc * kN, cn, Cout, C);
        if constexpr (kAhead)
          fetch_params(raw, offset, mask, b, ty0, tx0, kn, cn / cg, nsn, H, W, gk, pvec);
      }

      const bool live = cs < C;
      const float4* ps = prm + slot;
      const T* xb = x + (int64_t)b * hw * C + (live ? cs : 0);
      float* gxb = gx + (int64_t)b * hw * C + cs;
      if (live) {  // own samples (offset and mask gradients), one in flight
        OUnit<T> u;  // over a row of the gather
        const int m0 = tr * kTW + tc;
        issue_own(u, ps[m0 * kSlots], qy < H && tx0 + tc < W, ty0, tx0, xb, C, H, W);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r < 3) pull(gxa, ps, gcol, tr, tc, seg, ky, kx, r);
          float gc[kSeg];
          gcol8(gc, gcol, m0 + r, seg);
          own(u, gc, gxb, C, H, W, stg + seg * kSP + m0 + r, c0 % cg == 0);
          if (r < 3)
            issue_own(u, ps[(m0 + r + 1) * kSlots], qy < H && tx0 + tc + r + 1 < W, ty0, tx0, xb,
                      C, H, W);
        }
      }
      if (nch > 1 || gs + 1 == steps) {  // grad x of this thread's pixels: one flush
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (live && qy < H && tx0 + tc + i < W)
            add_corner(gxb, qy * W + tx0 + tc + i, C, gxa[i]);
#pragma unroll
          for (int j = 0; j < kSeg; ++j) gxa[i][j] = 0.f;
        }
      }
      if constexpr (kAhead) wait_copies();  // the next step's samples
      __syncthreads();  // the tile's grad_col, samples and staging are complete
      if ((c0 + kCK) % cg == 0 || cc == nch - 1)  // the chunk ends its groups
        store_sums(stg, goff, gmask, b, ty0, tx0, k, c0, C, cg, gk, H, W);
      if (kAhead && gs + 1 < steps) put_params(prm, raw, mask != nullptr, ty0, tx0, kn, nsn, H, W);
    }
  }
}

// K2 for the shapes the vector path does not take: one thread per (pixel,
// group, tap), grad_col formed element by element; grad x by scalar
// atomics into the same channels-last scratch.
template <typename T>
__global__ void __launch_bounds__(256)
dcn_bwd_data_kernel_any(const T* __restrict__ x, const T* __restrict__ offset,
                        const T* __restrict__ mask, const T* __restrict__ wt,
                        const T* __restrict__ gout, float* __restrict__ gx, T* __restrict__ goff,
                        T* __restrict__ gmask, int B, int C, int H, int W, int Cout, int gd) {
  const int hw = H * W, cg = C / gd, gk = gd * kTaps;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * gk * hw) return;
  const int pix = (int)(i % hw), j = (int)(i / hw % gk), b = (int)(i / hw / gk);
  const int g = j / kTaps, k = j % kTaps;
  const int64_t och = ((int64_t)b * 2 * gk + 2 * j) * hw + pix;
  const float m = mask ? ld(mask + ((int64_t)b * gk + j) * hw + pix) : 1.f;
  const Sample s = make_sample((float)(pix / W - 1 + k / 3) + ld(offset + och),
                               (float)(pix % W - 1 + k % 3) + ld(offset + och + hw), H, W);
  const int idx[4] = {s.i00, s.i01, s.i10, s.i11};
  const float hy = 1.f - s.ly, hx = 1.f - s.lx;
  const float w[4] = {hy * hx, hy * s.lx, s.ly * hx, s.ly * s.lx};
  float pm = 0.f, py = 0.f, px = 0.f;
  for (int c = g * cg; c < (g + 1) * cg; ++c) {
    float gc = 0.f;
    for (int o = 0; o < Cout; ++o) {
      const int64_t wi = sizeof(T) == 2 ? ((int64_t)k * C + c) * Cout + o
                                        : ((int64_t)k * Cout + o) * C + c;
      gc = fmaf(ld(wt + wi), ld(gout + ((int64_t)b * Cout + o) * hw + pix), gc);
    }
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[q] = idx[q] >= 0 ? ld(x + ((int64_t)b * hw + idx[q]) * C + c) : 0.f;
    const float gm = gc * m;
    pm = fmaf(gc, bilinear(s, a), pm);
    py = fmaf(gm, hx * (a[2] - a[0]) + s.lx * (a[3] - a[1]), py);
    px = fmaf(gm, hy * (a[1] - a[0]) + s.ly * (a[3] - a[2]), px);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (idx[q] >= 0) atomicAdd(gx + ((int64_t)b * hw + idx[q]) * C + c, gm * w[q]);
  }
  st(goff + och, py);
  st(goff + och + hw, px);
  if (gmask) st(gmask + ((int64_t)b * gk + j) * hw + pix, pm);
}

// K2's helpers: zero its grad x scratch, then write it out as NCHW in x's
// dtype (through a 32 x 32 tile, coalesced on both sides).
__global__ void __launch_bounds__(256) gx_zero(float* __restrict__ p, int64_t n) {
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = i0; i < n / 4; i += (int64_t)gridDim.x * blockDim.x)
    reinterpret_cast<float4*>(p)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i0 < n % 4) p[n / 4 * 4 + i0] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(256) gx_to_nchw(const float* __restrict__ gcl,
                                                  T* __restrict__ gx, int C, int hw) {
  __shared__ float tile[32][33];
  const int64_t b = blockIdx.z;
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int p = p0 + i, c = c0 + threadIdx.x;
    if (c < C && p < hw) tile[i][threadIdx.x] = gcl[(b * hw + p) * C + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, p = p0 + threadIdx.x;
    if (c < C && p < hw) st(gx + (b * C + c) * hw + p, tile[threadIdx.x][i]);
  }
}

// K3's helpers: zero its (9, Cout, C) scratch, then write it out as
// (Cout, C, 3, 3) in x's dtype.
__global__ void __launch_bounds__(256) gw_zero(float* __restrict__ p, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    p[i] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(256) gw_to_oihw(const float* __restrict__ s, T* __restrict__ gw,
                                                  int Cout, int C) {
  const int n = Cout * C * kTaps;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int k = i % kTaps, oc = i / kTaps;  // oc = o * C + c
    st(gw + i, s[(int64_t)k * Cout * C + oc]);
  }
}

static int sm_count() {
  int dev = 0, nsm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  return nsm;
}

static bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T>
static int launch_data(const void* x, const void* offset, const void* mask, const void* wt,
                       const void* gout, float* gcl, void* gx, void* goff, void* gmask, int B,
                       int C, int H, int W, int Cout, int gd, cudaStream_t stream) {
  const int hw = H * W, cg = C / gd;
  const int64_t n = (int64_t)B * hw * C;
  gx_zero<<<(unsigned)std::max<int64_t>(1, std::min<int64_t>((n / 4 + 255) / 256, 4096)), 256,
            0, stream>>>(gcl, n);
  if (C % kSeg == 0 && cg % kSeg == 0 && (kCK % cg == 0 || cg % kCK == 0) && H <= kMaxSide &&
      W <= kMaxSide) {
    const int noc = (Cout + kN - 1) / kN;
    const size_t smem = (size_t)noc * (kTP + kCK) * kN * sizeof(T) +
                        (kTP * kCK + 3 * kSeg * kSP) * sizeof(float) +
                        kSlots * kTP * sizeof(float4) +
                        (sizeof(T) == 2 ? 3 * kSlots * kRS * sizeof(T) : 0);
    auto kernel = dcn_bwd_data_kernel<T>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int ntx = (W + kTW - 1) / kTW, tpf = ntx * ((H + kTH - 1) / kTH), ntiles = B * tpf;
    const int slots = per_sm * sm_count();
    // Tap groups (1, 3 or 9 a tile): the fewest rounds of items a block
    // walks, each costing its taps plus one for the grad_out load and flush.
    int ntg = 1;
    int64_t best = -1;
    for (int g = 1; g <= kTaps; g *= 3) {
      const int64_t cost = ((int64_t)ntiles * g + slots - 1) / slots * (kTaps / g + 1);
      if (best < 0 || cost < best) best = cost, ntg = g;
    }
    const int nitems = ntiles * ntg;
    kernel<<<std::min(nitems, slots), kThreads, smem, stream>>>(
        (const T*)x, (const T*)offset, (const T*)mask, (const T*)wt, (const T*)gout, gcl,
        (T*)goff, (T*)gmask, C, H, W, Cout, gd, ntx, tpf, nitems, ntg);
  } else {
    const int64_t threads = (int64_t)B * gd * kTaps * hw;
    dcn_bwd_data_kernel_any<T><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
        (const T*)x, (const T*)offset, (const T*)mask, (const T*)wt, (const T*)gout, gcl,
        (T*)goff, (T*)gmask, B, C, H, W, Cout, gd);
  }
  gx_to_nchw<T><<<dim3((hw + 31) / 32, (C + 31) / 32, B), dim3(32, 8), 0, stream>>>(
      gcl, (T*)gx, C, hw);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
static int launch_weight_main(const void* x, const void* offset, const void* mask,
                              const void* gout, float* gsc, int B, int C, int H, int W, int Cout,
                              int gd, cudaStream_t stream) {
  const int hw = H * W, tpf = (hw + kP - 1) / kP, ntiles = B * tpf;
  const size_t smem = (kP * kCK + kN * kP) * sizeof(T);  // bf16 32 KB, fp32 64 KB
  auto kernel = dcn_bwd_weight_kernel<T, kVec>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int c_tiles = (C + kCK - 1) / kCK, o_tiles = (Cout + kN - 1) / kN;
  const int gy = kTaps * c_tiles * o_tiles;
  const int gxn = std::min(ntiles, std::max(1, per_sm * sm_count() / gy));
  const bool quads = hw % 4 == 0 && aligned16(offset) && aligned16(mask);
  const bool gvec = hw % (16 / (int)sizeof(T)) == 0 && aligned16(gout);
  kernel<<<dim3(gxn, gy), kThreads, smem, stream>>>(
      (const T*)x, (const T*)offset, (const T*)mask, (const T*)gout, gsc, C, H, W, Cout, gd, tpf,
      ntiles, c_tiles, quads, gvec);
  return 0;
}

template <typename T>
static int launch_weight(const void* x, const void* offset, const void* mask, const void* gout,
                         float* gsc, void* gw, int B, int C, int H, int W, int Cout, int gd,
                         cudaStream_t stream) {
  const int n = kTaps * Cout * C;
  gw_zero<<<std::max(1, std::min((n + 255) / 256, 1024)), 256, 0, stream>>>(gsc, n);
  int rc = 0;
  if (B * H * W > 0 && C % kSeg == 0 && (C / gd) % kSeg == 0)
    rc = launch_weight_main<T, true>(x, offset, mask, gout, gsc, B, C, H, W, Cout, gd, stream);
  else if (B * H * W > 0)
    rc = launch_weight_main<T, false>(x, offset, mask, gout, gsc, B, C, H, W, Cout, gd, stream);
  if (rc != 0) return rc;
  gw_to_oihw<T><<<std::max(1, std::min((n + 255) / 256, 1024)), 256, 0, stream>>>(gsc, (T*)gw,
                                                                                  Cout, C);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace dcn

// dtype: 0 = float32, 1 = bfloat16 for x, offset, mask, wt, grad_out and
// the three outputs. x is channels-last (B, H, W, C); wt is bf16 (9, C,
// Cout), fp32 (9, Cout, C). gcl: fp32 scratch of B*H*W*C for grad x;
// gx (B, C, H, W), goff (B, 2*Gd*9, H, W), gmask (B, Gd*9, H, W) need no
// initialising. mask and gmask may be null. Returns cudaGetLastError().
extern "C" int dcn_bwd_data(const void* x, const void* offset, const void* mask,
                            const void* wt, const void* gout, void* gcl, void* gx, void* goff,
                            void* gmask, int B, int C, int H, int W, int Cout, int gd, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || H * W == 0 || C == 0) return 0;
  if (dtype == 0)
    return dcn::bwd::launch_data<float>(x, offset, mask, wt, gout, (float*)gcl, gx, goff, gmask,
                                        B, C, H, W, Cout, gd, s);
  if (dtype == 1)
    return dcn::bwd::launch_data<__nv_bfloat16>(x, offset, mask, wt, gout, (float*)gcl, gx, goff,
                                                gmask, B, C, H, W, Cout, gd, s);
  return (int)cudaErrorInvalidValue;
}

// x channels-last as above; gsc: fp32 scratch of 9*Cout*C; gw (Cout, C, 3,
// 3) in the dtype, needs no initialising.
extern "C" int dcn_bwd_weight(const void* x, const void* offset, const void* mask,
                              const void* gout, void* gsc, void* gw, int B, int C, int H, int W,
                              int Cout, int gd, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout == 0 || C == 0) return 0;
  if (dtype == 0)
    return dcn::bwd::launch_weight<float>(x, offset, mask, gout, (float*)gsc, gw, B, C, H, W,
                                          Cout, gd, s);
  if (dtype == 1)
    return dcn::bwd::launch_weight<__nv_bfloat16>(x, offset, mask, gout, (float*)gsc, gw, B, C,
                                                  H, W, Cout, gd, s);
  return (int)cudaErrorInvalidValue;
}
