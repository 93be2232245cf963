// K2's kernel body (dcn_bwd.cu's notes give its design), shared by K2
// dcn_bwd_data and, with the tangent weight rule (kTan), by K10
// dcn_bwd_data_tangent (dcn_tangent.cu). K10 differs from K2 only in its
// corner weights and in what it sums over a group:
//   grad x      corner weight m w           -> m tw (dcn_common.cuh)
//   grad offset sum gc m (dv/dy, dv/dx)     -> (sum gc m h) (cx, cy),
//               h = x00 - x01 - x10 + x11 (d2 bilinear / dy dx)
//   grad mask   sum gc v, v = sum x w       -> sum gc d, d = sum x tw
// so it stages (cy, cx) beside each sample's entry, and two group sums
// (gc d, gc m h) where K2 stages three; the offset cotangent multiplies
// the second as it is stored.
#pragma once

#include <stdint.h>

#include "dcn_common.cuh"

namespace dcn {
namespace bwd {

// K2's tile: kTH x kTW output pixels of one frame, 128 in all (K10's on
// small frames: several whole frames, see Geo). grad x is
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

// The entry of the sample at frame pixel (py, px) of tap k with offsets
// (dy, dx) and mask mm: (ly, lx, mm, packed word), the position as
// position(). whole (tiles of whole frames): a sample is near only with
// its 4 corners in the frame, so a near corner never lands in another
// frame of the tile.
__device__ __forceinline__ float4 entry(int py, int px, int k, float dy, float dx, float mm,
                                        int H, int W, bool whole = false) {
  const int by = py - 1 + k / 3, bx = px - 1 + k % 3;
  const float ys = fminf(fmaxf((float)by + dy, -2.f), (float)(H + 1));
  const float xs = fminf(fmaxf((float)bx + dx, -2.f), (float)(W + 1));
  const float y0f = floorf(ys), x0f = floorf(xs);
  const int y0 = (int)y0f, x0 = (int)x0f;
  unsigned pk = pack_pos(y0, x0, y0 - by, x0 - bx);
  if (whole && !(y0 >= 0 && y0 + 1 < H && x0 >= 0 && x0 + 1 < W)) pk &= ~kNear;
  return make_float4(ys - y0f, xs - x0f, mm, __uint_as_float(pk));
}

// Where a tile's pixels lie. K2's tiles (K10's on larger frames) are kTH x
// kTW pixels of one frame: tile t is tile t % tpf of frame t / tpf, whose
// origin in the frame is (ty0, tx0) = (t % tpf / ntx * kTH, t % tpf % ntx *
// kTW). K10's tiles on frames of at most kTH rows and 4, 8 or 16 columns
// (fx > 0, "packed") hold fy x fx whole frames: tile pixel (r, c) lies in
// frame t fy fx + (r / H) fx + c / W, so small frames (the meta inner
// step's 8x8 and 4x4) fill a tile; a thread's 4 pixels of a row are in
// one frame.
struct Geo {
  int B, H, W, ntx, tpf, fx, fy;
};
// A tile pixel's frame b, and (oy, ox) that make (r + oy, c + ox) its row
// and column in the frame; in: the pixel lies in a frame (b is a frame
// either way, so a read there stays inside).
struct Where {
  int b, oy, ox;
  bool in;
};
__device__ __forceinline__ Where tile_base(const Geo& g, int tile) {
  Where w;
  w.b = tile / g.tpf;
  const int t = tile - w.b * g.tpf;
  w.oy = t / g.ntx * kTH;
  w.ox = t % g.ntx * kTW;
  w.in = true;
  return w;
}
// base: tile_base(g, tile), the answer for every pixel of an unpacked tile.
template <bool kPack>
__device__ __forceinline__ Where where(const Geo& g, const Where& base, int tile, int r, int c) {
  if (kPack && g.fx) {
    const int sy = r / g.H, sx = c / g.W;
    Where w;
    w.b = tile * g.fx * g.fy + sy * g.fx + sx;
    w.oy = -sy * g.H;
    w.ox = -sx * g.W;
    w.in = sy < g.fy && sx < g.fx && w.b < g.B;
    w.b = min(w.b, g.B - 1);
    return w;
  }
  Where w = base;
  w.in = r + w.oy < g.H && c + w.ox < g.W;
  return w;
}

// fp32: the samples of tap k, groups [g0, g0 + nslots), at every tile
// pixel: prm[m * kSlots + s] = entry(...), and with kTan the offset
// cotangent ctan[m * kSlots + s] = (cy, cx). Every load is issued before
// the first is used. (fp32 has no room for bf16's staging a step ahead: it
// would leave one block an SM.)
template <typename T, bool kTan>
__device__ __forceinline__ void load_params(float4* prm, float2* ctan, const T* offset,
                                            const T* mask, const T* coff, const Geo& g,
                                            const Where& base, int tile, int k, int g0,
                                            int nslots, int gk) {
  constexpr int kPE = kSlots * kTP / kThreads;  // entries a thread: 4
  constexpr int kV = kTan ? 5 : 3;              // dy, dx, mask (, cy, cx)
  const int H = g.H, W = g.W, hw = H * W, n = nslots * kTP;
  float raw[kPE][kV];
  bool in[kPE];
#pragma unroll
  for (int i = 0; i < kPE; ++i) {
    const int e = threadIdx.x + i * kThreads, s = e / kTP, m = e % kTP;
    const Where at = where<kTan>(g, base, tile, m / kTW, m % kTW);
    in[i] = e < n && at.in;
#pragma unroll
    for (int v = 0; v < kV; ++v) raw[i][v] = v == 2 ? 1.f : 0.f;
    if (in[i]) {
      const int j = (g0 + s) * kTaps + k, pix = (m / kTW + at.oy) * W + m % kTW + at.ox;
      const int64_t och = ((int64_t)at.b * 2 * gk + 2 * j) * hw + pix;
      raw[i][0] = ld(offset + och);
      raw[i][1] = ld(offset + och + hw);
      if (mask) raw[i][2] = ld(mask + ((int64_t)at.b * gk + j) * hw + pix);
      if constexpr (kTan) {
        raw[i][3] = ld(coff + och);
        raw[i][4] = ld(coff + och + hw);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPE; ++i) {
    const int e = threadIdx.x + i * kThreads, s = e / kTP, m = e % kTP;
    const Where at = where<kTan>(g, base, tile, m / kTW, m % kTW);
    const int py = m / kTW + at.oy, px = m % kTW + at.ox;
    if (e < n) {
      prm[m * kSlots + s] = in[i] ? entry(py, px, k, raw[i][0], raw[i][1], raw[i][2], H, W,
                                          kTan && g.fx)
                                  : make_float4(0.f, 0.f, 0.f, __uint_as_float(kOut));
      if constexpr (kTan) ctan[m * kSlots + s] = make_float2(raw[i][3], raw[i][4]);
    }
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

template <typename T, bool kPack>
__device__ __forceinline__ void load_gout(T* gt, const T* gout, const Geo& g, const Where& base,
                                          int tile, int noc, int Cout) {
  constexpr int kRB = 8;  // pairs a thread loads before it stores them
  const int hw = g.H * g.W, n = noc * (kN / 2) * kTP;
  for (int e0 = threadIdx.x; e0 < n; e0 += kRB * kThreads) {
    float v[kRB][2];
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      const int e = e0 + i * kThreads, m = e % kTP, o = e / kTP * 2;
      const Where at = where<kPack>(g, base, tile, m / kTW, m % kTW);
      const int y = m / kTW + at.oy, xq = m % kTW + at.ox;
      const bool in = e < n && at.in;
      const T* src = gout + ((int64_t)at.b * Cout + o) * hw + (in ? y * g.W + xq : 0);
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

// The group sums a sample stages: K2 (mask, dy, dx), K10 (mask, h).
template <bool kTan>
constexpr int kSums = kTan ? 2 : 3;

// The grad x weights of a sample's 4 corners (00, 01, 10, 11) before its
// mask: bilinear, or (kTan) their derivative along ct = (cy, cx).
template <bool kTan>
__device__ __forceinline__ void corner_w(float w[4], float ly, float lx, float2 ct) {
  if constexpr (kTan) {
    tangent_w(w, ly, lx, ct.x, ct.y);
  } else {
    const float hy = 1.f - ly, hx = 1.f - lx;
    w[0] = hy * hx, w[1] = hy * lx, w[2] = ly * hx, w[3] = ly * lx;
  }
}

// A sample's grad mask and grad offset shares, summed over its 8 channels
// into its segment's staging entries sg[i kSeg kSP] (K2: mask, dy, dx;
// K10: mask, m h; stored, or added where the group began in an earlier
// chunk), and the atomics of its grad x that no gather takes. ct: the
// sample's offset cotangent (kTan).
template <typename T, bool kTan>
__device__ __forceinline__ void own(const OUnit<T>& u, float2 ct, const float gc[kSeg],
                                    float* gxb, int C, int H, int W, float* sg, bool fresh) {
  const float ly = u.p.x, lx = u.p.y, m = u.p.z;
  float w[4];  // K10 needs its weights for d; K2 only where it pushes
  if constexpr (kTan) corner_w<true>(w, ly, lx, ct);
  float s[kSums<kTan>];
#pragma unroll
  for (int i = 0; i < kSums<kTan>; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const float a0 = chan(u.v[0], j), a1 = chan(u.v[1], j);
    const float a2 = chan(u.v[2], j), a3 = chan(u.v[3], j);
    if constexpr (kTan) {  // sum gc d, sum gc h
      const float d = fmaf(a3, w[3], fmaf(a2, w[2], fmaf(a1, w[1], a0 * w[0])));
      s[0] = fmaf(gc[j], d, s[0]);
      s[1] = fmaf(gc[j], (a0 - a1) - (a2 - a3), s[1]);
    } else {  // sum gc v, sum gc dv/dy, sum gc dv/dx
      const float d01 = a1 - a0, d23 = a3 - a2;
      const float top = fmaf(lx, d01, a0), dy = fmaf(lx, d23, a2) - top;
      s[0] = fmaf(gc[j], fmaf(ly, dy, top), s[0]);
      s[1] = fmaf(gc[j], dy, s[1]);
      s[2] = fmaf(gc[j], fmaf(ly, d23 - d01, d01), s[2]);
    }
  }
#pragma unroll
  for (int i = 1; i < kSums<kTan>; ++i) s[i] *= m;
#pragma unroll
  for (int i = 0; i < kSums<kTan>; ++i)
    sg[i * kSeg * kSP] = fresh ? s[i] : sg[i * kSeg * kSP] + s[i];
  if (u.push) {
    if constexpr (!kTan) corner_w<false>(w, ly, lx, ct);
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
// tile pixel whose near sample can have one of the 4 as a corner. prm (and
// ctan, kTan): this segment's group slot (stride kSlots).
template <bool kTan>
__device__ __forceinline__ void pull(float (&acc)[4][kSeg], const float4* prm,
                                     const float2* ctan, const float* gcol, int tr, int tc,
                                     int seg, int ky, int kx, int dr) {
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
    float2 ct = make_float2(0.f, 0.f);
    if constexpr (kTan) ct = ctan[m * kSlots];
    float gc[kSeg];
    gcol8(gc, gcol, m, seg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < dc - 2 || i > dc) continue;  // static: pixel i's reach
      const int bq = i - dc + 1 - fx;      // the corner column that lands on pixel i
      if ((unsigned)bq > 1u) continue;
      float w;
      if constexpr (kTan) {  // m tw of corner (a, bq)
        const float wx = bq ? p.y : 1.f - p.y;
        w = p.z * ((a ? ct.x : -ct.x) * wx + (bq ? ct.y : -ct.y) * (a ? p.x : 1.f - p.x));
      } else {
        w = wy * (bq ? p.y : 1.f - p.y);
      }
#pragma unroll
      for (int j = 0; j < kSeg; ++j) acc[i][j] = fmaf(w, gc[j], acc[i][j]);
    }
  }
}

// The offset and mask gradients of the groups of one (tap k, chunk c0)
// step from the staging: a group's segments summed, one plain store a
// value (two pixels a store where the frame's width allows), consecutive
// threads on consecutive pixels of a tile row. kTan: the dy / dx
// gradients are the (m h) sum times the sample's cx / cy, read from coff
// where they are stored.
template <typename T, bool kTan>
__device__ __forceinline__ void store_sums(const float* stg, T* goff, T* gmask, const T* coff,
                                           const Geo& g, const Where& base, int tile, int k,
                                           int c0, int C, int cg, int gk) {
  constexpr int kPairs = kTP / 2, kStride = kThreads / kPairs;
  const int H = g.H, W = g.W, hw = H * W, g0 = c0 / cg;
  const int spg = cg <= kCK ? cg / kSeg : kSlots;        // segments a group holds here
  const int ngr = cg <= kCK ? min(kCK, C - c0) / cg : 1;  // groups of the chunk
  const int m = threadIdx.x % kPairs * 2;
  const Where at = where<kTan>(g, base, tile, m / kTW, m % kTW);
  const int b = at.b, y = m / kTW + at.oy, xq = m % kTW + at.ox;
  if (!at.in) return;
  const bool two = xq + 1 < W, both = two && W % 2 == 0;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    if (v == 0 && !gmask) continue;
    const int row = kTan ? min(v, 1) : v;
    for (int gi = threadIdx.x / kPairs; gi < ngr; gi += kStride) {
      const float* src = stg + (row * kSeg + gi * spg) * kSP + m;
      float s0 = 0.f, s1 = 0.f;
      for (int q = 0; q < spg; ++q) {
        s0 += src[q * kSP];
        s1 += src[q * kSP + 1];
      }
      const int64_t j = (int64_t)(g0 + gi) * kTaps + k;
      if (kTan && v > 0) {  // goff_y = (m h) cx, goff_x = (m h) cy
        const T* cf = coff + ((int64_t)b * 2 * gk + 2 * j + 2 - v) * hw + y * W + xq;
        s0 *= ld(cf);
        if (two) s1 *= ld(cf + 1);
      }
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
// fp32), its samples (128 x 8 slots float4; kTan also their (cy, cx), 128 x
// 8 float2) and the staging of the offset and mask gradients (kSums x 8
// segments x 128 fp32). wt: bf16 (9, C, Cout), fp32 (9, Cout, C). bf16 K2
// also stages the next step's raw offsets and masks (3 x 8 x 130). Thread t owns
// segment t % 8 of the 4 pixels (t / 32, 4 (t / 8 % 4) ..): their samples'
// offset and mask gradients, and their grad x. kTan (K10): the tangent
// rule along coff; tiles of whole frames where g.fx > 0. The
// kernel body, run by K2's dcn_bwd_data_kernel and K10's
// dcn_bwd_data_tangent_kernel (kThreads threads, at most 2 blocks an SM).
template <typename T, bool kTan>
__device__ __forceinline__ void bwd_data_body(const T* __restrict__ x,
                                              const T* __restrict__ offset,
                                              const T* __restrict__ mask,
                                              const T* __restrict__ coff,
                                              const T* __restrict__ wt,
                                              const T* __restrict__ gout, float* __restrict__ gx,
                                              T* __restrict__ goff, T* __restrict__ gmask,
                                              Geo g, int C, int Cout, int gd, int nitems,
                                              int ntg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int noc = (Cout + kN - 1) / kN, nch = (C + kCK - 1) / kCK;
  T* gt = reinterpret_cast<T*>(smem);
  T* ws = gt + noc * kTP * kN;
  float* gcol = reinterpret_cast<float*>(ws + noc * kN * kCK);
  float4* prm = reinterpret_cast<float4*>(gcol + kTP * kCK);
  float2* ctan = reinterpret_cast<float2*>(prm + kSlots * kTP);  // kTan only
  float* stg = reinterpret_cast<float*>(ctan + (kTan ? kSlots * kTP : 0));
  T* raw = reinterpret_cast<T*>(stg + kSums<kTan> * kSeg * kSP);  // bf16 only
  // bf16 K2: samples staged a step ahead. K10 loads them at each step in
  // both dtypes: its (cy, cx) and its tiles of whole frames have no place in
  // the staging (fetch_params reads one frame's rows).
  constexpr bool kAhead = sizeof(T) == 2 && !kTan;
  const int H = g.H, W = g.W;
  const bool pvec = W % 2 == 0 && (uintptr_t)offset % 4 == 0 && (uintptr_t)mask % 4 == 0;
  const int hw = H * W, cg = C / gd, gk = gd * kTaps;
  const int kt = kTaps / ntg, steps = kt * nch;
  const int seg = unit_seg(), quad = threadIdx.x / kSeg;
  const int tr = quad / (kTW / 4), tc = quad % (kTW / 4) * 4;

  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int tile = item / ntg, k0 = item % ntg * kt;
    const Where base = tile_base(g, tile);
    // This thread's 4 pixels: frame q.b, row qy, columns tc + ox ..; one frame.
    const Where q = where<kTan>(g, base, tile, tr, tc);
    const int ty0 = q.oy, tx0 = q.ox, qy = ty0 + tr, b = q.b;
    const bool qin = kTan && g.fx ? q.in : qy < H;  // the row lies in the frame
    const int ns0 = cg <= kCK ? min(kCK, C) / cg : 1;
    __syncthreads();  // the last item is done with the grad_out tile and the weight slot
    if constexpr (kAhead)
      fetch_params(raw, offset, mask, b, ty0, tx0, k0, 0, ns0, H, W, gk, pvec);
    load_gout<T, kTan>(gt, gout, g, base, tile, noc, Cout);
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
        load_params<T, kTan>(prm, ctan, offset, mask, coff, g, base, tile, k, c0 / cg,
                             cg <= kCK ? min(kCK, C - c0) / cg : 1, gk);
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
      const float2* cts = ctan + slot;
      const T* xb = x + (int64_t)b * hw * C + (live ? cs : 0);
      float* gxb = gx + (int64_t)b * hw * C + cs;
      if (live) {  // own samples (offset and mask gradients), one in flight
        OUnit<T> u;  // over a row of the gather
        const int m0 = tr * kTW + tc;
        issue_own(u, ps[m0 * kSlots], qin && tx0 + tc < W, ty0, tx0, xb, C, H, W);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r < 3) pull<kTan>(gxa, ps, cts, gcol, tr, tc, seg, ky, kx, r);
          float gc[kSeg];
          gcol8(gc, gcol, m0 + r, seg);
          own<T, kTan>(u, kTan ? cts[(m0 + r) * kSlots] : make_float2(0.f, 0.f), gc, gxb, C, H,
                       W, stg + seg * kSP + m0 + r, c0 % cg == 0);
          if (r < 3)
            issue_own(u, ps[(m0 + r + 1) * kSlots], qin && tx0 + tc + r + 1 < W, ty0, tx0, xb,
                      C, H, W);
        }
      }
      if (nch > 1 || gs + 1 == steps) {  // grad x of this thread's pixels: one flush
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (live && qin && tx0 + tc + i < W)
            add_corner(gxb, qy * W + tx0 + tc + i, C, gxa[i]);
#pragma unroll
          for (int j = 0; j < kSeg; ++j) gxa[i][j] = 0.f;
        }
      }
      if constexpr (kAhead) wait_copies();  // the next step's samples
      __syncthreads();  // the tile's grad_col, samples and staging are complete
      if ((c0 + kCK) % cg == 0 || cc == nch - 1)  // the chunk ends its groups
        store_sums<T, kTan>(stg, goff, gmask, coff, g, base, tile, k, c0, C, cg, gk);
      if (kAhead && gs + 1 < steps) put_params(prm, raw, mask != nullptr, ty0, tx0, kn, nsn, H, W);
    }
  }
}

// K2 for the shapes the vector path does not take: one thread per (pixel,
// group, tap), grad_col formed element by element; grad x by scalar
// atomics into the same channels-last scratch. kTan: K10's rule, as above.
// The body of K2's dcn_bwd_data_kernel_any and K10's
// dcn_bwd_data_tangent_kernel_any (256 threads a block).
template <typename T, bool kTan>
__device__ __forceinline__ void bwd_data_any_body(const T* __restrict__ x,
                                                  const T* __restrict__ offset,
                                                  const T* __restrict__ mask,
                                                  const T* __restrict__ coff,
                                                  const T* __restrict__ wt,
                                                  const T* __restrict__ gout,
                                                  float* __restrict__ gx, T* __restrict__ goff,
                                                  T* __restrict__ gmask, int B, int C, int H,
                                                  int W, int Cout, int gd) {
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
  float2 ct = make_float2(0.f, 0.f);
  if constexpr (kTan) ct = make_float2(ld(coff + och), ld(coff + och + hw));
  float w[4];
  corner_w<kTan>(w, s.ly, s.lx, ct);
  const float hy = 1.f - s.ly, hx = 1.f - s.lx;
  float pm = 0.f, py = 0.f, px = 0.f;  // kTan: py sums gc m h, px is unused
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
    if constexpr (kTan) {
      pm = fmaf(gc, tangent(s.ly, s.lx, ct.x, ct.y, a), pm);
      py = fmaf(gm, (a[0] - a[1]) - (a[2] - a[3]), py);
    } else {
      pm = fmaf(gc, bilinear(s, a), pm);
      py = fmaf(gm, hx * (a[2] - a[0]) + s.lx * (a[3] - a[1]), py);
      px = fmaf(gm, hy * (a[1] - a[0]) + s.ly * (a[3] - a[2]), px);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (idx[q] >= 0) atomicAdd(gx + ((int64_t)b * hw + idx[q]) * C + c, gm * w[q]);
  }
  if constexpr (kTan) {  // goff_y = (sum gc m h) cx, goff_x = (sum gc m h) cy
    px = py * ct.x;
    py *= ct.y;
  }
  st(goff + och, py);
  st(goff + och + hw, px);
  if (gmask) st(gmask + ((int64_t)b * gk + j) * hw + pix, pm);
}

// Tap groups of a tile (1, 3 or 9): the fewest rounds of items a block
// walks, each costing its taps plus one for the grad_out load and flush.
static inline int tap_groups(int64_t ntiles, int slots) {
  int ntg = 1;
  int64_t best = -1;
  for (int g = 1; g <= kTaps; g *= 3) {
    const int64_t cost = (ntiles * g + slots - 1) / slots * (kTaps / g + 1);
    if (best < 0 || cost < best) best = cost, ntg = g;
  }
  return ntg;
}

}  // namespace bwd
}  // namespace dcn
