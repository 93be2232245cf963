// Shared pieces of the modulated deformable conv kernels (dcn_fwd.cu,
// dcn_bwd.cu): element loads/stores for fp32 and bf16, and the bilinear
// sample of one (group, tap, pixel) position with the CUDA reference's
// rule that each corner outside the image contributes zero.
//
// Layouts (NCHW, contiguous), shared by all three kernels:
//   x      (B, C, H, W)
//   offset (B, 2*Gd*9, H, W)  channel 2*(g*9+k) is dy, 2*(g*9+k)+1 is dx
//   mask   (B, Gd*9, H, W)    post-sigmoid, or null (all ones)
// Kernel 3x3, stride 1, padding 1, dilation 1; conv groups 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcn {

constexpr int kTaps = 9;
constexpr int kTileP = 64;    // output pixels per block tile
constexpr int kTileC = 64;    // input channels per block tile
constexpr int kTileO = 64;    // output channels per block tile
constexpr int kThreads = 256;

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

// Sampling position, corner set and modulation of (b, g, k) at pixel pix.
template <typename T>
__device__ __forceinline__ Sample sample_at(const T* offset, const T* mask, int b, int g,
                                            int k, int pix, int H, int W, int gk,
                                            float* m) {
  const int64_t hw = (int64_t)H * W;
  const int oy = pix / W, ox = pix - (pix / W) * W;
  const int64_t och = (int64_t)b * 2 * gk + 2 * (g * kTaps + k);
  const float dy = ld(offset + och * hw + pix);
  const float dx = ld(offset + (och + 1) * hw + pix);
  *m = mask ? ld(mask + ((int64_t)b * gk + g * kTaps + k) * hw + pix) : 1.f;
  return make_sample((float)(oy - 1 + k / 3) + dy, (float)(ox - 1 + k % 3) + dx, H, W);
}

template <typename T>
__device__ __forceinline__ void corners(const T* plane, const Sample& s, float v[4]) {
  v[0] = s.i00 >= 0 ? ld(plane + s.i00) : 0.f;
  v[1] = s.i01 >= 0 ? ld(plane + s.i01) : 0.f;
  v[2] = s.i10 >= 0 ? ld(plane + s.i10) : 0.f;
  v[3] = s.i11 >= 0 ? ld(plane + s.i11) : 0.f;
}

__device__ __forceinline__ float bilinear(const Sample& s, const float v[4]) {
  const float hy = 1.f - s.ly, hx = 1.f - s.lx;
  return hy * (hx * v[0] + s.lx * v[1]) + s.ly * (hx * v[2] + s.lx * v[3]);
}

// Fill a (kTileC x ldc) shared column tile for tap k: col[c][p] =
// mask * bilinear(x[b, c0+c]) at pixel p0+p; zero for p or c out of range.
// Thread t owns pixel t % 64 and channels [16*(t/64), 16*(t/64)+16), so a
// warp writes 32 consecutive pixels of one channel, and one sample
// position is reused for all channels of a group the thread holds.
template <typename T>
__device__ __forceinline__ void fill_columns(float* col, int ldc, const T* x, const T* offset,
                                             const T* mask, int b, int k, int c0, int p0,
                                             int C, int H, int W, int gd) {
  const int hw = H * W, cg = C / gd, gk = gd * kTaps;
  const int pl = threadIdx.x % kTileP, cq = threadIdx.x / kTileP;
  const int pix = p0 + pl;
  int last_g = -1;
  Sample s;
  float m = 0.f;
  for (int j = 0; j < 16; ++j) {
    const int cl = cq * 16 + j, c = c0 + cl;
    float val = 0.f;
    if (pix < hw && c < C) {
      const int g = c / cg;
      if (g != last_g) {
        s = sample_at(offset, mask, b, g, k, pix, H, W, gk, &m);
        last_g = g;
      }
      float v[4];
      corners(x + ((int64_t)b * C + c) * hw, s, v);
      val = m * bilinear(s, v);
    }
    col[cl * ldc + pl] = val;
  }
}

}  // namespace dcn
