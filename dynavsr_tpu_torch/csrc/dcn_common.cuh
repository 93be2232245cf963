// Shared pieces of the modulated deformable conv kernels (dcn_fwd.cu,
// dcn_bwd.cu, dcn_tangent.cu): element loads/stores for fp32 and bf16, the
// bilinear sample with the CUDA reference's rule that each corner outside
// the image contributes zero, and the channels-last gather and tensor-core
// product that K1 dcn_fwd introduced and K2 / K3 / K8-K10 reuse.
//
// The weight rule. The gather blends a sample's 4 corners with weights
// m * w_corner, w the bilinear weights (kTan false: K1-K3), or with their
// derivative along an offset cotangent (cy, cx) (kTan true: K8, K9, the
// tangent columns of the DCN's second order):
//   tw_corner = cy * d w_corner / dy + cx * d w_corner / dx
// both 0 for a corner outside the frame.
//
// Layouts, shared by all three kernels:
//   x      (B, C, H, W) NCHW at the C entries; the kernels read it
//          channels-last, (B, H, W, C)
//   offset (B, 2*Gd*9, H, W)  channel 2*(g*9+k) is dy, 2*(g*9+k)+1 is dx
//   mask   (B, Gd*9, H, W)    post-sigmoid, or null (all ones)
// Kernel 3x3, stride 1, padding 1, dilation 1; conv groups 1.
//
// The gather. A block works on tiles of kP = 128 output pixels of one
// frame, one (tap, 64-channel chunk) step at a time. A step's 128 x 8
// units (pixel, 8-channel segment) are spread so that thread t holds
// segment t % 8 of 4 consecutive pixels (one a round): warp w owns pixels
// 16 w .. 16 w + 15, lane l the 4 from 16 w + 4 (l % 32 / 8). Its offsets
// and masks of a step are one vector load each, and the 8 lanes of a
// quarter-warp hold the 8 segments of one pixel, so where the groups'
// offsets land on the same corner pixels (as EDVR's do) one 128-byte line
// serves them all. The 8 channels of a corner are one 16-byte load in bf16
// (two in fp32). A corner outside the frame is read at its clamped
// position with weight 0, as the plain version does, so every load is
// unconditional (positions clamped into [-2, size + 1] as make_sample
// does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcn {

constexpr int kTaps = 9;
constexpr int kThreads = 256;
constexpr int kP = 128;                 // output pixels per tile
constexpr int kCK = 64;                 // input channels per step
constexpr int kN = 64;                  // output channels per block
constexpr int kSeg = 8;                 // channels per gather unit
constexpr int kRoundC = 16;             // product channels a round (one k16)
constexpr int kRounds = kCK / kRoundC;  // 4 rounds a step
// A step's 128 x 8 gather units: 32 lanes' quads of 4 pixels x 8 segments.
static_assert(kThreads / kSeg * kRounds == kP, "a lane gathers one pixel a round");

// The card's SM count (host).
static inline int sm_count() {
  int dev = 0, nsm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  return nsm;
}

// How many blocks of `kernel` (kThreads each, `smem` bytes of dynamic
// shared memory) the card holds at once: blocks an SM times SMs, the
// attribute that allows that memory set first. Asked once a device and
// size (memo), so a launcher that runs on every call pays a lookup.
struct Slots {
  size_t smem;
  int n;
};
template <typename K>
static int grid_slots(K kernel, size_t smem, Slots (&memo)[16]) {
  int dev = 0;
  cudaGetDevice(&dev);
  Slots& m = memo[dev & 15];
  if (m.n == 0 || m.smem != smem) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    m = Slots{smem, per_sm * sm_count()};
  }
  return m.n;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One bilinear sample position: the four corner indices into an (H, W)
// plane (-1 where the corner is outside) and the fractional parts.
struct Sample {
  int i00, i01, i10, i11;
  float ly, lx;
};

__device__ __forceinline__ Sample make_sample(float ys, float xs, int H, int W) {
  // Clamping into [-2, size+1] keeps the int conversion defined; every
  // corner of a clamped position is outside, as it was before clamping.
  ys = fminf(fmaxf(ys, -2.f), (float)(H + 1));
  xs = fminf(fmaxf(xs, -2.f), (float)(W + 1));
  const float y0f = floorf(ys), x0f = floorf(xs);
  const int y0 = (int)y0f, x0 = (int)x0f;
  const bool y0in = y0 >= 0 && y0 < H, y1in = y0 + 1 >= 0 && y0 + 1 < H;
  const bool x0in = x0 >= 0 && x0 < W, x1in = x0 + 1 >= 0 && x0 + 1 < W;
  Sample s;
  s.i00 = (y0in && x0in) ? y0 * W + x0 : -1;
  s.i01 = (y0in && x1in) ? y0 * W + x0 + 1 : -1;
  s.i10 = (y1in && x0in) ? (y0 + 1) * W + x0 : -1;
  s.i11 = (y1in && x1in) ? (y0 + 1) * W + x0 + 1 : -1;
  s.ly = ys - y0f;
  s.lx = xs - x0f;
  return s;
}

__device__ __forceinline__ float bilinear(const Sample& s, const float v[4]) {
  const float hy = 1.f - s.ly, hx = 1.f - s.lx;
  return hy * (hx * v[0] + s.lx * v[1]) + s.ly * (hx * v[2] + s.lx * v[3]);
}

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

__device__ __forceinline__ int unit_seg() { return (int)threadIdx.x % kSeg; }
__device__ __forceinline__ int quad_px() {  // this thread's first pixel in the tile
  return (int)threadIdx.x / 32 * 16 + (int)threadIdx.x % 32 / kSeg * 4;
}

struct Tile {
  int b, pix0;  // frame; this thread's first pixel in it
};

// The tiles of K1 and K3 are tpf tiles of each frame: `geo` is tpf. Those
// of K8 and K9 (kFlat) walk the flattened (frame, pixel) index with frames
// `geo` pixels apart, H * W rounded up to 4, so one tile spans frames and a
// thread's 4 pixels never straddle two; a quad past the last of the B
// frames is placed past the end of the last one: every pixel off, every
// read inside.
template <bool kFlat = false>
__device__ __forceinline__ Tile tile_at(int tile, int geo, int B = 0) {
  Tile t;
  if constexpr (kFlat) {
    const int f = tile * kP + quad_px();
    t.b = f / geo;
    t.pix0 = f - t.b * geo;
    if (t.b >= B) {
      t.b = B - 1;
      t.pix0 = geo;
    }
  } else {
    t.b = tile / geo;
    t.pix0 = (tile - t.b * geo) * kP + quad_px();
  }
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

// The offsets and masks (and with the tangent rule the offset cotangents)
// of this thread's units of one step, loaded at once so their latency is
// paid once a step, not once a unit.
struct Pre {
  float dy[kRounds], dx[kRounds], m[kRounds], by[kRounds], bx[kRounds];
  float cy[kRounds], cx[kRounds];  // kTan only
  unsigned on;  // bit r: unit r lies in the frame and in C
};

template <bool kTan, typename T>
__device__ __forceinline__ void prefetch(Pre& p, const T* offset, const T* mask, const T* coff,
                                         Tile tl, int k, int c0, int C, int H, int W,
                                         float inv_w, int cg, int gk, bool quads) {
  static_assert(kRounds == 4, "a unit's 4 pixels are one vector load");
  const int hw = H * W, c = c0 + unit_seg() * kSeg;
  const int g = c < C ? c / cg : 0;
  const int64_t och = ((int64_t)tl.b * 2 * gk + 2 * (g * kTaps + k)) * hw + tl.pix0;
  const T* dyp = offset + och;
  const T* cyp = kTan ? coff + och : nullptr;
  const T* mp = mask ? mask + ((int64_t)tl.b * gk + g * kTaps + k) * hw + tl.pix0 : nullptr;
  int oy, ox;
  row_col(tl.pix0, W, inv_w, &oy, &ox);
  p.on = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    p.by[r] = (float)(oy - 1 + k / 3);
    p.bx[r] = (float)(ox - 1 + k % 3);
    p.dy[r] = p.dx[r] = p.m[r] = 0.f;
    if constexpr (kTan) p.cy[r] = p.cx[r] = 0.f;
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
    if constexpr (kTan) {
      ld4(cyp, p.cy);
      ld4(cyp + hw, p.cx);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (p.on >> r & 1u) {
        p.dy[r] = ld(dyp + r);
        p.dx[r] = ld(dyp + hw + r);
        p.m[r] = mp ? ld(mp + r) : 1.f;
        if constexpr (kTan) {
          p.cy[r] = ld(cyp + r);
          p.cx[r] = ld(cyp + hw + r);
        }
      }
    }
  }
}

// The sample position of this thread's unit of round r: its fractional
// parts, which of its rows and columns lie in the frame, and its corners'
// pixel indices clamped into the frame.
struct Pos {
  float ly, lx;
  bool y0in, y1in, x0in, x1in;
  int idx[4];
};

__device__ __forceinline__ Pos position(const Pre& p, int r, int H, int W) {
  // The position clamped into [-2, size + 1] as make_sample does.
  const float ys = fminf(fmaxf(p.by[r] + p.dy[r], -2.f), (float)(H + 1));
  const float xs = fminf(fmaxf(p.bx[r] + p.dx[r], -2.f), (float)(W + 1));
  const float y0f = floorf(ys), x0f = floorf(xs);
  const int y0 = (int)y0f, x0 = (int)x0f;
  Pos q;
  q.ly = ys - y0f;
  q.lx = xs - x0f;
  q.y0in = y0 >= 0 && y0 < H;
  q.y1in = y0 + 1 >= 0 && y0 + 1 < H;
  q.x0in = x0 >= 0 && x0 < W;
  q.x1in = x0 + 1 >= 0 && x0 + 1 < W;
  const int ya = min(max(y0, 0), H - 1) * W, yb = min(max(y0 + 1, 0), H - 1) * W;
  const int xa = min(max(x0, 0), W - 1), xb1 = min(max(x0 + 1, 0), W - 1);
  q.idx[0] = ya + xa;
  q.idx[1] = ya + xb1;
  q.idx[2] = yb + xa;
  q.idx[3] = yb + xb1;
  return q;
}

// The 16-byte loads of the 8 channels at each corner of q. xb: x
// (channels-last) at this frame and segment's channel.
template <typename T>
__device__ __forceinline__ void load_corners(uint4 (&v)[4][kVecs<T>], const Pos& q, const T* xb,
                                             int C) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4* src = reinterpret_cast<const uint4*>(xb + (int64_t)q.idx[c] * C);
#pragma unroll
    for (int i = 0; i < kVecs<T>; ++i) v[c][i] = __ldg(src + i);
  }
}

// The derivative along (cy, cx) of the bilinear weights of the corners
// 00, 01, 10, 11 of a sample with fractional parts (ly, lx).
__device__ __forceinline__ void tangent_w(float w[4], float ly, float lx, float cy, float cx) {
  const float hy = 1.f - ly, hx = 1.f - lx;
  w[0] = -cy * hx - cx * hy;
  w[1] = cx * hy - cy * lx;
  w[2] = cy * hx - cx * ly;
  w[3] = cy * lx + cx * ly;
}

// The derivative of the bilinear sample along (cy, cx) from its corners
// v (0 outside the frame) and fractional parts.
__device__ __forceinline__ float tangent(float ly, float lx, float cy, float cx,
                                        const float v[4]) {
  float w[4];
  tangent_w(w, ly, lx, cy, cx);
  return v[0] * w[0] + v[1] * w[1] + v[2] * w[2] + v[3] * w[3];
}

// Vector gather, first half: issue the corner loads of this thread's unit
// of round r, and form its corner weights by the weight rule.
template <bool kTan, typename T>
__device__ __forceinline__ void issue(Unit<T>& u, const Pre& p, const T* xb, int r, int C,
                                      int H, int W) {
  const Pos q = position(p, r, H, W);
  const float m = (p.on >> r & 1u) ? p.m[r] : 0.f;
  if constexpr (kTan) {
    float tw[4];
    tangent_w(tw, q.ly, q.lx, p.cy[r] * m, p.cx[r] * m);
    u.w[0] = q.y0in && q.x0in ? tw[0] : 0.f;
    u.w[1] = q.y0in && q.x1in ? tw[1] : 0.f;
    u.w[2] = q.y1in && q.x0in ? tw[2] : 0.f;
    u.w[3] = q.y1in && q.x1in ? tw[3] : 0.f;
  } else {
    const float wy0 = q.y0in ? m * (1.f - q.ly) : 0.f;
    const float wy1 = q.y1in ? m * q.ly : 0.f;
    const float wx0 = q.x0in ? 1.f - q.lx : 0.f;
    const float wx1 = q.x1in ? q.lx : 0.f;
    u.w[0] = wy0 * wx0;
    u.w[1] = wy0 * wx1;
    u.w[2] = wy1 * wx0;
    u.w[3] = wy1 * wx1;
  }
  load_corners(u.v, q, xb, C);
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
template <bool kTan, typename T>
__device__ __forceinline__ void gather_any(float val[kSeg], const T* x, const T* offset,
                                           const T* mask, const T* coff, Tile tl, int k, int c0,
                                           int r, int C, int H, int W, int cg, int gk) {
  const int hw = H * W, pix = tl.pix0 + r, cs = c0 + unit_seg() * kSeg;
  int last_g = -1;
  Sample s;
  float m = 0.f, cy = 0.f, cx = 0.f;
  for (int j = 0; j < kSeg; ++j) {
    const int c = cs + j;
    val[j] = 0.f;
    if (pix >= hw || c >= C) continue;
    const int g = c / cg;
    if (g != last_g) {
      const int64_t och = (int64_t)tl.b * 2 * gk + 2 * (g * kTaps + k);
      const float dy = ld(offset + och * hw + pix), dx = ld(offset + (och + 1) * hw + pix);
      m = mask ? ld(mask + ((int64_t)tl.b * gk + g * kTaps + k) * hw + pix) : 1.f;
      if constexpr (kTan) {
        cy = ld(coff + och * hw + pix);
        cx = ld(coff + (och + 1) * hw + pix);
      }
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
    val[j] = m * (kTan ? tangent(s.ly, s.lx, cy, cx, v) : bilinear(s, v));
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

// Gather the column tile of step (tap k, channels [c0, c0 + 64)) of tile
// tl into dst, round by round, running between(r) after the corner loads
// of round r (and in bf16 of round r + 1) are issued. kTan: the tangent
// rule, along the offset cotangent coff (as offset; in bf16 the tangent
// columns are rounded to bf16 as K1's columns are).
template <typename T, bool kVec, bool kTan, typename F>
__device__ __forceinline__ void gather_step(T* dst, const T* x, const T* offset, const T* mask,
                                            const T* coff, Tile tl, int k, int c0, int C, int H,
                                            int W, float inv_w, int cg, int gk, bool quads,
                                            F&& between) {
  if constexpr (kVec) {
    Pre p;
    prefetch<kTan>(p, offset, mask, coff, tl, k, c0, C, H, W, inv_w, cg, gk, quads);
    const int cs = c0 + unit_seg() * kSeg;  // past C (C < 64) its weights are 0: read channel 0
    const T* xb = x + (int64_t)tl.b * H * W * C + (cs < C ? cs : 0);
    if constexpr (sizeof(T) == 2) {  // two units in flight: 20 registers each
      Unit<T> u[2];
      issue<kTan>(u[0], p, xb, 0, C, H, W);
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (r + 1 < kRounds) issue<kTan>(u[(r + 1) & 1], p, xb, r + 1, C, H, W);
        between(r);
        float val[kSeg];
        blend(u[r & 1], val);
        store_col(dst, r, val);
      }
    } else {  // fp32 units are 36 registers: one in flight
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        Unit<T> u;
        issue<kTan>(u, p, xb, r, C, H, W);
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
      gather_any<kTan>(val, x, offset, mask, coff, tl, k, c0, r, C, H, W, cg, gk);
      store_col(dst, r, val);
    }
  }
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

// A 64 x 64 weight slice of tap k, in the layout the product reads: rows
// [o0, o0 + 64) of wt's second axis, columns [c0, c0 + 64) of its third.
//  bf16: wt is (9, O, C); the slot is [64 o][64 c], swizzled as col.
//  fp32: wt is (9, C, O); the slot is [64 c][64 o].
// (K1 reads its weight as (o, c) = (out, in) channels; K2 with the roles
// of the two swapped.)
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// B fragments of round r for a warp's 32 N-rows from n0: a [N][64 K] tile
// swizzled as col; b[nj] covers N-rows n0 + 16 nj .. + 16, K [16 r, 16 r + 16).
__device__ __forceinline__ void b_frags(uint32_t (&b)[2][4], const __nv_bfloat16* ws, int n0,
                                        int r) {
  const int lane = threadIdx.x & 31, ch = r * kRoundC / 8;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int row = n0 + nj * 16 + (lane & 7) + ((lane >> 4) << 3), j = ch + ((lane >> 3) & 1);
    ldmatrix_x4(b[nj], ws + row * kCK + ((j ^ (row & 7)) << 3));
  }
}

// Round r of K1's product: channels [16 r, 16 r + 16) of the step.
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
  b_frags(b, ws, n0, r);
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

// Where element e of a thread's 32 product accumulators lies in the
// 128-pixel x 64-channel output tile (both dtypes' layouts above).
template <typename T>
__device__ __forceinline__ void acc_pos(int e, int* p, int* n) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mi = e >> 4, ni = (e >> 2) & 3, q = e & 3;
    *p = (warp & 3) * 32 + mi * 16 + (lane >> 2) + (q >> 1) * 8;
    *n = (warp >> 2) * 32 + ni * 8 + (lane & 3) * 2 + (q & 1);
  } else {
    const int i = e >> 2, j = e & 3;
    *p = (i >> 2) * 64 + (threadIdx.x & 15) * 4 + (i & 3);
    *n = ((int)threadIdx.x >> 4) * 4 + j;
  }
}

}  // namespace dcn
