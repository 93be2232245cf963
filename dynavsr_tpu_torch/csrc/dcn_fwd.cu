// K1 dcn_fwd — modulated deformable conv v2, forward, for sm_90a.
//
// Replaces: dynavsr_tpu/ops/dcn_fused.py:deform_conv2d_fused (the XLA
// gather-interpolate-contract kernel the JAX models run), with the
// modulate-and-contract epilogue that
// tools/pallas_consume_experiment.py:pallas_consume wrote in Pallas fused
// into the same kernel body.
//
//   out[b,o,p] = bias[o] + sum_{k,c} W[o,c,k] * m[b,g(c),k,p]
//                          * bilinear(x[b,c], p + p_k + offset[b,g(c),k,p])
//
// What bounds it on the H100 (80GB HBM3, 700 W; chip_smoke.py, PERF.md): at
// EDVR's inference call (40 frames of 144x176, C = Cout = 64, Gd 8) the
// function moves 0.70 GB in bf16 (offset and mask are 62 % of it: 0.208 ms
// at 3.35 TB/s) against 74.7 GFLOP (0.076 ms at 989 TFLOP/s): bytes bound
// it. In fp32 it moves 1.40 GB (0.416 ms) and, with TF32 off, its FMAs on
// the CUDA cores bound it (1.116 ms at 67 TFLOP/s). What the card spends
// is neither: it is the gather, 73 M (pixel, tap, group) samples of 4
// corners each, whose positions depend on loaded offsets, so every sample
// is a dependent chain of loads. The first version of this kernel ran its
// product as fp32 FMAs in both dtypes, gathered one element at a time from
// NCHW planes, never overlapped the gather with the product, and reloaded
// every weight slice per step from device memory.
//
// Design. GEMM view: M = output pixels, N = Cout, K = 9 taps x C. A block
// owns 64 output channels and walks pixel tiles of 128 (a persistent grid:
// two blocks an SM). One step is one (tap, 64-channel chunk): its column
// tile (128 px x 64 ch) is mask x bilinear sample, formed in fp32 and
// stored in shared memory in the dtype of the product.
//  - bf16: the product runs on the tensor cores, mma.sync.m16n8k16 with
//    bf16 operands and fp32 accumulators (the column tile is rounded to
//    bf16 once, as JAX's kernel casts its columns to the compute dtype).
//    Column and weight tiles are stored XOR-swizzled in 16-byte chunks so
//    the ldmatrix reads and the gather's 16-byte stores are conflict-free.
//    mma.sync rather than wgmma: the tensor cores are not what bounds K1
//    (the product is a small part of its time); a warp-level product keeps
//    the gather and the product in the same warps, each warp running its
//    share of the product between issuing its corner loads and using them.
//  - fp32: IEEE fp32 FMAs (TF32 would miss the 1e-4 tolerance), an 8 px x
//    4 out-channel register tile per thread, float4 shared-memory reads.
//  - Weights: each step's 64 x 64 slice is copied into a two-slot ring by
//    cp.async, one step ahead, from L2 (the whole weight is 72 KB in bf16).
//    Keeping all 9 slices resident, the first plan, costs 72 KB of each
//    block's shared memory and so most of the SM's L1, which the corner
//    loads need more: on EDVR's own inputs the resident build was slower.
//  - Gather: x is read channels-last (B, H, W, C), copied by a prologue
//    kernel, so the 8 channels of one (pixel, tap, group) sample are one
//    16-byte load per corner in bf16 (two in fp32). A lane owns 4
//    consecutive pixels of one 8-channel group: their offsets and masks of
//    a step are one vector load each, prefetched at the step's start; the 8
//    lanes of a quarter-warp are the 8 groups of one pixel, so where the
//    groups' offsets fall on the same corner pixels (as EDVR's do) one
//    128-byte line serves all 8. Corners outside the frame are read at
//    their clamped position with weight 0, as the plain version does, so
//    every load is unconditional (positions clamped into [-2, size + 1] as
//    dcn_common.cuh:make_sample does).
//  - Overlap: the column and weight tiles are double-buffered, one barrier
//    a step. A step is 4 rounds; in round r a thread issues the corner
//    loads of its unit of the NEXT step (in bf16 also round r + 1's), runs
//    the product of 16 channels of the CURRENT step, then blends the
//    corners that arrived into the other buffer.
// Shapes the vector gather does not take (C or C / Gd not a multiple of 8)
// gather element by element, with the same arithmetic.
#include <stdint.h>

#include <algorithm>

#include "dcn_common.cuh"

namespace dcn {
namespace fwd {

constexpr int kP = 128;                         // output pixels per tile
constexpr int kCK = 64;                         // input channels per step
constexpr int kN = 64;                          // output channels per block
constexpr int kSeg = 8;                         // channels per gather unit
constexpr int kRoundC = 16;                     // product channels a round (one k16)
constexpr int kRounds = kCK / kRoundC;          // 4 rounds a step
// A step's 128 x 8 gather units: 32 lanes' quads of 4 pixels x 8 segments.
static_assert(kThreads / kSeg * kRounds == kP, "a lane gathers one pixel a round");

template <typename T>
constexpr int kVecs = kSeg * (int)sizeof(T) / 16;  // 16-byte loads per unit corner

// One gather unit in flight: the raw corners of 8 channels and the
// weights (corner weight x mask) that blend them.
template <typename T>
struct Unit {
  uint4 v[4][kVecs<T>];
  float w[4];
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Channel j (0..7) of a unit corner, as fp32.
__device__ __forceinline__ float chan(const uint4 (&v)[1], int j) {
  const uint32_t u = word(v[0], j >> 1);
  return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
}
__device__ __forceinline__ float chan(const uint4 (&v)[2], int j) {
  return __uint_as_float(word(v[j >> 2], j & 3));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The units this thread gathers in a step: 4 consecutive pixels of the
// tile (one a round) in its 8-channel segment t % 8. Warp w owns pixels
// 16 w .. 16 w + 15, lane l the 4 from 16 w + 4 (l % 32 / 8): its offsets
// and masks of a step are one vector load each, and the 8 lanes of a
// quarter-warp hold the 8 segments of one pixel, so where the groups'
// offsets land on the same corner pixels (as EDVR's do) one 128-byte line
// serves them all.
__device__ __forceinline__ int unit_seg() { return (int)threadIdx.x % kSeg; }
__device__ __forceinline__ int quad_px() {  // this thread's first pixel in the tile
  return (int)threadIdx.x / 32 * 16 + (int)threadIdx.x % 32 / kSeg * 4;
}

struct Tile {
  int b, pix0;  // frame; this thread's first pixel in it
};

__device__ __forceinline__ Tile tile_at(int tile, int tpf) {
  Tile t;
  t.b = tile / tpf;
  t.pix0 = (tile - t.b * tpf) * kP + quad_px();
  return t;
}

// Row and column of pixel pix of a W-wide frame, without an integer
// division: the float quotient is within one of the row, then corrected.
__device__ __forceinline__ void row_col(int pix, int W, float inv_w, int* oy, int* ox) {
  int y = (int)(((float)pix + 0.5f) * inv_w);
  int x = pix - y * W;
  if (x < 0) {
    --y;
    x += W;
  } else if (x >= W) {
    ++y;
    x -= W;
  }
  *oy = y;
  *ox = x;
}

// Four consecutive values as fp32 (p 8-byte aligned in bf16, 16 in fp32).
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void ld4(const float* p, float v[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}

// The offsets and masks of this thread's units of one step, loaded at
// once so their latency is paid once a step, not once a unit.
struct Pre {
  float dy[kRounds], dx[kRounds], m[kRounds], by[kRounds], bx[kRounds];
  unsigned on;  // bit r: unit r lies in the frame and in C
};

template <typename T>
__device__ __forceinline__ void prefetch(Pre& p, const T* offset, const T* mask, Tile tl, int k,
                                         int c0, int C, int H, int W, float inv_w, int cg,
                                         int gk, bool quads) {
  static_assert(kRounds == 4, "a unit's 4 pixels are one vector load");
  const int hw = H * W, c = c0 + unit_seg() * kSeg;
  const int g = c < C ? c / cg : 0;
  const T* dyp = offset + ((int64_t)tl.b * 2 * gk + 2 * (g * kTaps + k)) * hw + tl.pix0;
  const T* mp = mask ? mask + ((int64_t)tl.b * gk + g * kTaps + k) * hw + tl.pix0 : nullptr;
  int oy, ox;
  row_col(tl.pix0, W, inv_w, &oy, &ox);
  p.on = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    p.by[r] = (float)(oy - 1 + k / 3);
    p.bx[r] = (float)(ox - 1 + k % 3);
    p.dy[r] = p.dx[r] = p.m[r] = 0.f;
    if (c < C && tl.pix0 + r < hw) p.on |= 1u << r;
    if (++ox == W) {
      ox = 0;
      ++oy;
    }
  }
  if (p.on == 0xfu && quads) {
    ld4(dyp, p.dy);
    ld4(dyp + hw, p.dx);
    if (mp) ld4(mp, p.m);
    else p.m[0] = p.m[1] = p.m[2] = p.m[3] = 1.f;
  } else {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (p.on >> r & 1u) {
        p.dy[r] = ld(dyp + r);
        p.dx[r] = ld(dyp + hw + r);
        p.m[r] = mp ? ld(mp + r) : 1.f;
      }
    }
  }
}

// Vector gather, first half: issue the corner loads of this thread's unit
// of round r. xb: x (channels-last) at this frame and segment's channel.
// As in the plain version, a corner outside the frame is read at its
// clamped position with weight 0, so every load is unconditional.
template <typename T>
__device__ __forceinline__ void issue(Unit<T>& u, const Pre& p, const T* xb, int r, int C,
                                      int H, int W) {
  // The position clamped into [-2, size + 1] as make_sample does.
  const float ys = fminf(fmaxf(p.by[r] + p.dy[r], -2.f), (float)(H + 1));
  const float xs = fminf(fmaxf(p.bx[r] + p.dx[r], -2.f), (float)(W + 1));
  const float y0f = floorf(ys), x0f = floorf(xs);
  const int y0 = (int)y0f, x0 = (int)x0f;
  const float ly = ys - y0f, lx = xs - x0f, m = (p.on >> r & 1u) ? p.m[r] : 0.f;
  const float wy0 = (y0 >= 0 && y0 < H) ? m * (1.f - ly) : 0.f;
  const float wy1 = (y0 + 1 >= 0 && y0 + 1 < H) ? m * ly : 0.f;
  const float wx0 = (x0 >= 0 && x0 < W) ? 1.f - lx : 0.f;
  const float wx1 = (x0 + 1 >= 0 && x0 + 1 < W) ? lx : 0.f;
  u.w[0] = wy0 * wx0;
  u.w[1] = wy0 * wx1;
  u.w[2] = wy1 * wx0;
  u.w[3] = wy1 * wx1;
  const int ya = min(max(y0, 0), H - 1) * W, yb = min(max(y0 + 1, 0), H - 1) * W;
  const int xa = min(max(x0, 0), W - 1), xb1 = min(max(x0 + 1, 0), W - 1);
  const int idx[4] = {ya + xa, ya + xb1, yb + xa, yb + xb1};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4* src = reinterpret_cast<const uint4*>(xb + (int64_t)idx[q] * C);
#pragma unroll
    for (int i = 0; i < kVecs<T>; ++i) u.v[q][i] = __ldg(src + i);
  }
}

// Vector gather, second half: blend the corners into 8 column values.
template <typename T>
__device__ __forceinline__ void blend(const Unit<T>& u, float val[kSeg]) {
#pragma unroll
  for (int j = 0; j < kSeg; ++j)
    val[j] = fmaf(u.w[3], chan(u.v[3], j),
                  fmaf(u.w[2], chan(u.v[2], j), fmaf(u.w[1], chan(u.v[1], j),
                                                      u.w[0] * chan(u.v[0], j))));
}

// Element-by-element gather of the same 8 column values, for shapes whose
// groups do not fall on 8-channel boundaries. x is channels-last.
template <typename T>
__device__ __forceinline__ void gather_any(float val[kSeg], const T* x, const T* offset,
                                           const T* mask, Tile tl, int k, int c0, int r, int C,
                                           int H, int W, int cg, int gk) {
  const int hw = H * W, pix = tl.pix0 + r, cs = c0 + unit_seg() * kSeg;
  int last_g = -1;
  Sample s;
  float m = 0.f;
  for (int j = 0; j < kSeg; ++j) {
    const int c = cs + j;
    val[j] = 0.f;
    if (pix >= hw || c >= C) continue;
    const int g = c / cg;
    if (g != last_g) {
      const int64_t och = (int64_t)tl.b * 2 * gk + 2 * (g * kTaps + k);
      const float dy = ld(offset + och * hw + pix), dx = ld(offset + (och + 1) * hw + pix);
      m = mask ? ld(mask + ((int64_t)tl.b * gk + g * kTaps + k) * hw + pix) : 1.f;
      s = make_sample((float)(pix / W - 1 + k / 3) + dy, (float)(pix % W - 1 + k % 3) + dx, H,
                      W);
      last_g = g;
    }
    const T* base = x + (int64_t)tl.b * hw * C + c;
    float v[4];
    v[0] = s.i00 >= 0 ? ld(base + (int64_t)s.i00 * C) : 0.f;
    v[1] = s.i01 >= 0 ? ld(base + (int64_t)s.i01 * C) : 0.f;
    v[2] = s.i10 >= 0 ? ld(base + (int64_t)s.i10 * C) : 0.f;
    v[3] = s.i11 >= 0 ? ld(base + (int64_t)s.i11 * C) : 0.f;
    val[j] = m * bilinear(s, v);
  }
}

// Store a unit's 8 column values into the column tile.
//  bf16: [pixel][64 ch], 16-byte chunk j of row p at chunk j ^ (p & 7);
//  fp32: [64 ch][pixel], 4-pixel group q of channel c at q ^ (c / 8).
__device__ __forceinline__ int col_px(int p, int c) { return p ^ (((c >> 3) & 7) << 2); }
__device__ __forceinline__ void store_col(__nv_bfloat16* col, int r, const float val[kSeg]) {
  const int p = quad_px() + r, j = unit_seg();
  uint4 q;
  q.x = pack_bf16(val[0], val[1]);
  q.y = pack_bf16(val[2], val[3]);
  q.z = pack_bf16(val[4], val[5]);
  q.w = pack_bf16(val[6], val[7]);
  *reinterpret_cast<uint4*>(col + p * kCK + ((j ^ (p & 7)) << 3)) = q;
}
__device__ __forceinline__ void store_col(float* col, int r, const float val[kSeg]) {
  const int p = quad_px() + r, j = unit_seg();
#pragma unroll
  for (int i = 0; i < kSeg; ++i) col[(j * kSeg + i) * kP + col_px(p, j * kSeg)] = val[i];
}

// Copy n (0..8) elements to 8 in shared memory, zero-filling the rest;
// whole aligned rows go by cp.async (no registers; wait_copies() waits).
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src, int n, bool vec) {
  if (vec && n == kSeg) {
#pragma unroll
    for (int i = 0; i < kVecs<T>; ++i) {
      const uint32_t d = (uint32_t)__cvta_generic_to_shared(reinterpret_cast<uint4*>(dst) + i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :
                   : "r"(d), "l"(reinterpret_cast<const uint4*>(src) + i));
    }
    return;
  }
  for (int i = 0; i < kSeg; ++i) st(dst + i, i < n ? ld(src + i) : 0.f);
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The weight slice of step s = (tap k, chunk c0) for out-channels
// [o0, o0 + 64), in the layout the product reads.
//  bf16: wt is (9, Cout, C); the slot is [64 out][64 ch], swizzled as col.
//  fp32: wt is (9, C, Cout); the slot is [64 ch][64 out].
__device__ __forceinline__ void load_slice(__nv_bfloat16* slot, const __nv_bfloat16* wt, int k,
                                           int c0, int o0, int C, int Cout) {
  for (int e = threadIdx.x; e < kN * kCK / kSeg; e += kThreads) {
    const int o = e >> 3, j = e & 7, c = c0 + j * kSeg;
    const int n = (o0 + o < Cout) ? max(0, min(kSeg, C - c)) : 0;
    copy8(slot + o * kCK + ((j ^ (o & 7)) << 3), wt + ((int64_t)k * Cout + o0 + o) * C + c, n,
          C % kSeg == 0);
  }
}
__device__ __forceinline__ void load_slice(float* slot, const float* wt, int k, int c0, int o0,
                                           int C, int Cout) {
  for (int e = threadIdx.x; e < kN * kCK / kSeg; e += kThreads) {
    const int c = e >> 3, j = e & 7, o = o0 + j * kSeg;
    const int n = (c0 + c < C) ? max(0, min(kSeg, Cout - o)) : 0;
    copy8(slot + c * kN + j * kSeg, wt + ((int64_t)k * C + c0 + c) * Cout + o, n,
          Cout % 4 == 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Round r of the product: channels [16 r, 16 r + 16) of the step.
//  bf16: warp w owns pixels 32 (w % 4) .. +32 and out-channels 32 (w / 4)
//  .. +32: 2 x 4 m16n8k16 tiles, acc[(mi * 4 + ni) * 4 + e].
__device__ __forceinline__ void contract(const __nv_bfloat16* col, const __nv_bfloat16* ws,
                                         int r, float (&acc)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * 32, ch = r * kRoundC / 8;
  uint32_t a[2][4], b[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int row = m0 + mi * 16 + (lane & 15), j = ch + (lane >> 4);
    ldmatrix_x4(a[mi], col + row * kCK + ((j ^ (row & 7)) << 3));
  }
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int row = n0 + nj * 16 + (lane & 7) + ((lane >> 4) << 3), j = ch + ((lane >> 3) & 1);
    ldmatrix_x4(b[nj], ws + row * kCK + ((j ^ (row & 7)) << 3));
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_bf16(acc + (mi * 4 + ni) * 4, a[mi], b[ni >> 1][(ni & 1) * 2],
               b[ni >> 1][(ni & 1) * 2 + 1]);
}
//  fp32: thread t owns pixels 4 (t % 16) + {0..3} and 64 + the same, and
//  out-channels 4 (t / 16) + {0..3}: acc[i * 4 + j].
__device__ __forceinline__ void contract(const float* col, const float* ws, int r,
                                         float (&acc)[32]) {
  const int tp = threadIdx.x & 15, to = threadIdx.x >> 4;
#pragma unroll
  for (int h = 0; h < kRoundC / kSeg; ++h) {
    const int c = r * kRoundC + h * kSeg;  // the swizzle is one per 8 channels
    const float* pa = col + c * kP + col_px(tp * 4, c);
    const float* pb = col + c * kP + col_px(64 + tp * 4, c);
    const float* pw = ws + c * kN + to * 4;
#pragma unroll
    for (int cl = 0; cl < kSeg; ++cl) {
      const float4 a0 = *reinterpret_cast<const float4*>(pa + cl * kP);
      const float4 a1 = *reinterpret_cast<const float4*>(pb + cl * kP);
      const float4 w = *reinterpret_cast<const float4*>(pw + cl * kN);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(a[i], wv[j], acc[i * 4 + j]);
    }
  }
}

// Bias, and the finished tile out to NCHW in out's dtype.
template <typename T>
__device__ __forceinline__ void epilogue(float (&acc)[32], T* out, const T* bias, int tile,
                                         int tpf, int o0, int hw, int Cout) {
  const int b = tile / tpf, p0 = (tile - b * tpf) * kP;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    int p, o;
    if constexpr (sizeof(T) == 2) {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int mi = e >> 4, ni = (e >> 2) & 3, q = e & 3;
      p = (warp & 3) * 32 + mi * 16 + (lane >> 2) + (q >> 1) * 8;
      o = (warp >> 2) * 32 + ni * 8 + (lane & 3) * 2 + (q & 1);
    } else {
      const int i = e >> 2, j = e & 3;
      p = (i >> 2) * 64 + (threadIdx.x & 15) * 4 + (i & 3);
      o = ((int)threadIdx.x >> 4) * 4 + j;
    }
    const int pix = p0 + p, oc = o0 + o;
    if (pix < hw && oc < Cout)
      st(out + ((int64_t)b * Cout + oc) * hw + pix, acc[e] + (bias ? ld(bias + oc) : 0.f));
    acc[e] = 0.f;
  }
}

// One block: out-channels [64 y, 64 y + 64); pixel tiles x, x + gridDim.x, ...
// Shared memory: the column ring (2 x 128 x 64) and the weight ring (2
// slices of 64 x 64), each filled one step ahead. x is channels-last.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dcn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
               const T* __restrict__ mask, const T* __restrict__ wt,
               const T* __restrict__ bias, T* __restrict__ out, int C, int H, int W, int Cout,
               int gd, int tpf, int ntiles, int nch, bool quads) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* col = reinterpret_cast<T*>(smem);
  T* wsm = col + 2 * kP * kCK;
  const int cg = C / gd, gk = gd * kTaps, steps = kTaps * nch;
  const int o0 = blockIdx.y * kN;
  const float inv_w = 1.f / (float)W;
  int tile = blockIdx.x;
  if (tile >= ntiles) return;

  // Gather the column tile and the weight slice of step gs of tile tl into
  // ring slot `slot`, round by round, running between(r) after the corner
  // loads of round r (and in bf16 of round r + 1) are issued.
  auto gather = [&](int slot, Tile tl, int gs, auto&& between) {
    const int k = gs / nch, c0 = (gs % nch) * kCK;
    T* dst = col + slot * kP * kCK;
    load_slice(wsm + slot * kCK * kN, wt, k, c0, o0, C, Cout);
    if constexpr (kVec) {
      Pre p;
      prefetch(p, offset, mask, tl, k, c0, C, H, W, inv_w, cg, gk, quads);
      const int cs = c0 + unit_seg() * kSeg;  // past C (C < 64) its weights are 0: read channel 0
      const T* xb = x + (int64_t)tl.b * H * W * C + (cs < C ? cs : 0);
      if constexpr (sizeof(T) == 2) {  // two units in flight: 20 registers each
        Unit<T> u[2];
        issue(u[0], p, xb, 0, C, H, W);
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          if (r + 1 < kRounds) issue(u[(r + 1) & 1], p, xb, r + 1, C, H, W);
          between(r);
          float val[kSeg];
          blend(u[r & 1], val);
          store_col(dst, r, val);
        }
      } else {  // fp32 units are 36 registers: one in flight
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          Unit<T> u;
          issue(u, p, xb, r, C, H, W);
          between(r);
          float val[kSeg];
          blend(u, val);
          store_col(dst, r, val);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        between(r);
        float val[kSeg];
        gather_any(val, x, offset, mask, tl, k, c0, r, C, H, W, cg, gk);
        store_col(dst, r, val);
      }
    }
    wait_copies();  // the weight slice, before the barrier that publishes it
  };

  Tile cur = tile_at(tile, tpf);
  gather(0, cur, 0, [](int) {});
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int s = 0, ring = 0;; ring ^= 1) {
    int ntile = tile, ns = s + 1;
    if (ns == steps) {
      ns = 0;
      ntile += gridDim.x;
    }
    const bool more = ntile < ntiles;  // the same in every thread of the block
    const T* cs = col + ring * kP * kCK;
    const T* ws = wsm + ring * kCK * kN;
    auto product = [&](int r) { contract(cs, ws, r, acc); };
    const Tile nxt = ntile == tile ? cur : tile_at(ntile, tpf);
    if (more) {
      gather(ring ^ 1, nxt, ns, product);
    } else {
#pragma unroll
      for (int r = 0; r < kRounds; ++r) product(r);
    }
    if (s == steps - 1) epilogue(acc, out, bias, tile, tpf, o0, H * W, Cout);
    if (!more) break;
    __syncthreads();
    tile = ntile;
    s = ns;
    cur = nxt;
  }
}

// NCHW -> channels-last (B, H*W, C) copy of x, through a 32 x 32 tile in
// shared memory so both the reads (along pixels) and the writes (along
// channels) are coalesced.
template <typename T>
__global__ void __launch_bounds__(256) to_channels_last(const T* __restrict__ x,
                                                        T* __restrict__ xcl, int C, int hw) {
  __shared__ T tile[32][33];
  const int64_t b = blockIdx.z;
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, p = p0 + threadIdx.x;
    if (c < C && p < hw) tile[i][threadIdx.x] = x[(b * C + c) * hw + p];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int p = p0 + i, c = c0 + threadIdx.x;
    if (c < C && p < hw) xcl[(b * hw + p) * C + c] = tile[threadIdx.x][i];
  }
}

template <typename T, bool kVec>
static int launch(const void* x, void* xcl, const void* offset, const void* mask,
                  const void* wt, const void* bias, void* out, int B, int C, int H, int W,
                  int Cout, int gd, cudaStream_t stream) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  const int hw = H * W;
  const size_t smem = (2 * kP * kCK + 2 * kCK * kN) * sizeof(T);  // bf16 48 KB, fp32 96 KB
  auto kernel = dcn_fwd_kernel<T, kVec>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  to_channels_last<T><<<dim3((hw + 31) / 32, (C + 31) / 32, B), dim3(32, 8), 0, stream>>>(
      (const T*)x, (T*)xcl, C, hw);
  const int tpf = (hw + kP - 1) / kP, ntiles = B * tpf, gy = (Cout + kN - 1) / kN;
  const int gx = std::min(ntiles, std::max(1, per_sm * nsm / gy));
  // Offsets and masks load 4 pixels at a time where every plane starts aligned.
  const bool quads = hw % 4 == 0 && (uintptr_t)offset % 16 == 0 && (uintptr_t)mask % 16 == 0;
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      (const T*)xcl, (const T*)offset, (const T*)mask, (const T*)wt, (const T*)bias, (T*)out,
      C, H, W, Cout, gd, tpf, ntiles, (C + kCK - 1) / kCK, quads);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* x, void* xcl, const void* offset, const void* mask,
                    const void* wt, const void* bias, void* out, int B, int C, int H, int W,
                    int Cout, int gd, cudaStream_t s) {
  if (C % kSeg == 0 && (C / gd) % kSeg == 0)
    return launch<T, true>(x, xcl, offset, mask, wt, bias, out, B, C, H, W, Cout, gd, s);
  return launch<T, false>(x, xcl, offset, mask, wt, bias, out, B, C, H, W, Cout, gd, s);
}

}  // namespace fwd
}  // namespace dcn

// x, offset, mask and out NCHW (dcn_common.cuh); xcl: scratch of x's size
// for its channels-last copy. wt: bf16 (9, Cout, C), fp32 (9, C, Cout).
// dtype: 0 = float32, 1 = bfloat16 (all tensors share it). mask and bias
// may be null. Returns cudaGetLastError() after the launches.
extern "C" int dcn_fwd(const void* x, void* xcl, const void* offset, const void* mask,
                       const void* wt, const void* bias, void* out, int B, int C, int H, int W,
                       int Cout, int gd, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || H * W == 0 || Cout == 0) return 0;
  if (dtype == 0)
    return dcn::fwd::dispatch<float>(x, xcl, offset, mask, wt, bias, out, B, C, H, W, Cout, gd,
                                     s);
  if (dtype == 1)
    return dcn::fwd::dispatch<__nv_bfloat16>(x, xcl, offset, mask, wt, bias, out, B, C, H, W,
                                             Cout, gd, s);
  return (int)cudaErrorInvalidValue;
}
