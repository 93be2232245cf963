// K7 duf_bwd — the gradients of K6 (DUF's dynamic upsampling filter), for
// sm_90a.
//
// Replaces: the JAX-autodiff backward of
// dynavsr_tpu/models/duf.py:dynamic_upsampling_filter (line 47), which every
// DUF adaptation step runs: the loss flows back into the filters, which
// come from the filter head's parameters.
//
//   grad_f[b, k, r, h, w] = sum_c x[b, c, h+i-2, w+j-2] * g[b, c*R + r, h, w]
//   grad_x[b, c, y, x]    = sum_{i, j} sum_r g[b, c*R + r, y+2-i, x+2-j]
//                                          * f[b, 5i+j, r, y+2-i, x+2-j]
//
// over the (y+2-i, x+2-j) inside the frame. Both are gathers: each thread
// owns the values it writes, so there are no atomics and the result is
// the same from run to run. grad_f is always computed (written in the
// filters' dtype); grad_x only when asked for (on DUF's path x is input
// data and it never is), and that path is kept correct, not fast.
//
// What bounds it on the H100 (80GB HBM3, 700 W; PERF.md): bytes, and they
// are a write stream. grad_f is 25 R values a pixel against C values of x
// and C R of g read: at the adaptation call DUF runs (8 x 36 x 44, C = 3,
// R = 16) 20.3 MB of fp32 writes (10.1 MB in bf16) of 22.9 MB in all, 6.8 us
// at 3.35 TB/s (3.8 us with bf16 filters), for 0.03 GFLOP. The first
// version (one thread a pixel walking all R filters, 8 x 32 tiles, scalar
// stores) filled 80 of the 132 SMs with 62 % of its lanes owning a pixel,
// and each thread issued 400 scalar stores behind a chain of dependent
// gradient loads: latency-bound, and slower in bf16 than in fp32 (2-byte
// stores, 64 bytes a warp).
//
// Design: the grid splits R into groups of kRb filters (x: column blocks x
// R groups, y: row blocks, z: frames), so the adaptation call makes 256
// blocks, and the block fits the frame (launch: 22 column pairs x 9 rows at
// 36 x 44, every lane of a row owning two pixels). A block stages x's C
// planes over its tile with a 2-pixel zero halo in shared memory, once per
// R group (x is 152 KB, so the reloads stay in L2), kLd loads in flight a
// thread. A thread owns 2 adjacent pixels: it issues its C x kRb gradient
// loads (float2) before the tile load, so their latency overlaps it, then
// walks the 5 tap rows, reading each channel's 6 x values of the row as
// three float2 from shared memory and forming 5 taps x 2 pixels for each of
// its filters, written at once as one float2 (fp32) or one packed bf16x2
// (bf16) store a tap and filter. An odd W, or a ragged edge, takes the
// scalar path.
#include "duf_common.cuh"

namespace duf {

constexpr int kPx = 2;   // adjacent pixels a thread
constexpr int kRb = 2;   // filters (r) a block
constexpr int kLd = 8;   // tile loads in flight a thread
constexpr size_t kSmemMax = 48 * 1024;  // what a launch gets without opting in

// A thread's two values of one grad_f plane: one vector store where `vec`.
__device__ __forceinline__ void st2(float* p, float a, float b, bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (n > 1) p[1] = b;
  }
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b, bool vec, int n) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (n > 1) p[1] = __float2bfloat16(b);
  }
}

// kC: channels unrolled, their gradients held in registers (3), or 0 for C
// taken at run time, gradients reloaded from L1. Block (bx, by): bx column
// pairs x by rows; the tile: C planes of (by + 4) x (2 bx + 4) floats.
template <typename TF, int kC>
__global__ void __launch_bounds__(256)
duf_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               TF* __restrict__ gf, int C_, int R, int H, int W, int ncb, bool vec) {
  extern __shared__ float2 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int kCu = kC > 0 ? kC : 1;
  const int C = kC > 0 ? kC : C_;
  const int bx = blockDim.x, by = blockDim.y;
  const int tp = 2 * bx + 4, th = by + 4;  // tile pitch (even) and height
  const int grp = blockIdx.x / ncb, cb = blockIdx.x - grp * ncb;
  const int r0 = grp * kRb, nr = min(kRb, R - r0);
  const int w0 = cb * bx * kPx, h0 = blockIdx.y * by;
  const int j0 = w0 + threadIdx.x * kPx, h = h0 + threadIdx.y;
  const bool live = h < H && j0 < W;
  const int n = vec ? kPx : min(kPx, W - j0);
  const int64_t b = blockIdx.z, hw = (int64_t)H * W, p = (int64_t)h * W + j0;
  // g[b, c*R + r0 + rr] at this thread's pixels.
  auto gptr = [&](int c, int rr) { return g + ((b * C + c) * R + r0 + rr) * hw + p; };
  auto load2 = [&](const float* q, float* v) {
    if (vec) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(q));
      v[0] = a.x, v[1] = a.y;
    } else {
      v[0] = __ldg(q);
      v[1] = n > 1 ? __ldg(q + 1) : 0.f;
    }
  };

  float gv[kCu][kRb][kPx] = {};
  if (kC > 0 && live) {
#pragma unroll
    for (int c = 0; c < kCu; ++c)
#pragma unroll
      for (int rr = 0; rr < kRb; ++rr)
        if (rr < nr) load2(gptr(c, rr), gv[c][rr]);
  }

  // The tile, kLd loads in flight a thread (a loop of one load and one
  // store would wait out a load's latency once per element).
  const int nt = bx * by, tid = threadIdx.y * bx + threadIdx.x;
  const int plane = th * tp, total = C * plane;
  for (int i0 = tid; i0 < total; i0 += kLd * nt) {
    float v[kLd];
#pragma unroll
    for (int u = 0; u < kLd; ++u) {
      const int i = i0 + u * nt;
      v[u] = 0.f;
      if (i < total) {
        const int c = i / plane, yy = (i - c * plane) / tp, xx = i - c * plane - yy * tp;
        const int y = h0 + yy - kRad, xq = w0 + xx - kRad;
        if (y >= 0 && y < H && xq >= 0 && xq < W)
          v[u] = __ldg(x + ((b * C + c) * H + y) * (int64_t)W + xq);
      }
    }
#pragma unroll
    for (int u = 0; u < kLd; ++u)
      if (i0 + u * nt < total) tile[i0 + u * nt] = v[u];
  }
  __syncthreads();
  if (!live) return;

  const float* t0 = tile + threadIdx.y * tp + threadIdx.x * kPx;
  TF* out = gf + (b * kTaps * R + r0) * hw + p;  // plane (b, k, r0 + rr): + (k R + rr) hw
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    // acc[rr][j][e]: tap 5 i + j of filter r0 + rr at pixel e.
    float acc[kRb][5][kPx] = {};
    for (int c0 = 0; c0 < C; c0 += kCu) {
#pragma unroll
      for (int cu = 0; cu < kCu; ++cu) {
        const int c = c0 + cu;
        const float2* row = reinterpret_cast<const float2*>(t0 + (c * th + i) * tp);
        float xr[2 * kPx + 2];  // the row's 6 x values around the 2 pixels
#pragma unroll
        for (int u = 0; u < kPx + 1; ++u) {
          const float2 v = row[u];
          xr[2 * u] = v.x, xr[2 * u + 1] = v.y;
        }
#pragma unroll
        for (int rr = 0; rr < kRb; ++rr) {
          float gr[kPx];
          if (kC > 0) {
            gr[0] = gv[cu][rr][0], gr[1] = gv[cu][rr][1];
          } else if (rr < nr) {
            load2(gptr(c, rr), gr);
          } else {
            gr[0] = gr[1] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < 5; ++j)
#pragma unroll
            for (int e = 0; e < kPx; ++e) acc[rr][j][e] = fmaf(xr[j + e], gr[e], acc[rr][j][e]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRb; ++rr)
      if (rr < nr)
#pragma unroll
        for (int j = 0; j < 5; ++j)
          st2(out + ((int64_t)(5 * i + j) * R + rr) * hw, acc[rr][j][0], acc[rr][j][1], vec, n);
  }
}

template <typename TF>
__global__ void __launch_bounds__(kThreads)
duf_bwd_x_kernel(const TF* __restrict__ filt, const float* __restrict__ g,
                 float* __restrict__ gx, int B, int C, int R, int H, int W) {
  const int64_t hw = (int64_t)H * W;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)B * C * hw) return;
  const int64_t bc = t / hw;
  const int p = (int)(t - bc * hw);
  const int64_t b = bc / C;
  const int c = (int)(bc - b * C);
  const int y = p / W, xq = p - (p / W) * W;
  float acc = 0.f;
  for (int i = 0; i < 5; ++i) {
    const int py = y + kRad - i;
    if (py < 0 || py >= H) continue;
    for (int j = 0; j < 5; ++j) {
      const int px = xq + kRad - j;
      if (px < 0 || px >= W) continue;
      const int64_t q = (int64_t)py * W + px;
      const TF* fq = filt + (b * kTaps + i * 5 + j) * R * hw + q;
      const float* gq = g + (b * C + c) * R * hw + q;
      for (int r = 0; r < R; ++r) acc = fmaf(__ldg(gq + r * hw), ld(fq + r * hw), acc);
    }
  }
  gx[t] = acc;
}

inline bool aligned(const void* p, size_t n) { return (uintptr_t)p % n == 0; }

template <typename TF>
int launch(const float* x, const TF* filt, const float* gout, TF* gfilt, float* gx, int B,
           int C, int R, int H, int W, cudaStream_t s) {
  if (gfilt) {
    // Block: as many column pairs as the row has (at most 32), then rows up
    // to 256 threads, balanced over the row blocks, fewer where C planes of
    // the tile would pass 48 KB of shared memory.
    const int cols = (W + kPx - 1) / kPx;
    const int bx = cols < 32 ? cols : 32;
    int by = 256 / bx;
    auto smem = [&](int y) { return (size_t)C * (y + 2 * kRad) * (2 * bx + 2 * kRad) * 4; };
    while (by > 1 && smem(by) > kSmemMax) --by;
    const int rbs = (H + by - 1) / by;
    by = (H + rbs - 1) / rbs;
    const int ncb = (cols + bx - 1) / bx, ngrp = (R + kRb - 1) / kRb;
    const dim3 grid(ncb * ngrp, rbs, B), block(bx, by);
    const bool vec = W % kPx == 0 && aligned(gout, 8) && aligned(gfilt, kPx * sizeof(TF));
    if (C == 3)
      duf_bwd_kernel<TF, 3><<<grid, block, smem(by), s>>>(x, gout, gfilt, C, R, H, W, ncb, vec);
    else
      duf_bwd_kernel<TF, 0><<<grid, block, smem(by), s>>>(x, gout, gfilt, C, R, H, W, ncb, vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (gx) {
    const int64_t n = (int64_t)B * C * H * W;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    duf_bwd_x_kernel<TF><<<blocks, kThreads, 0, s>>>(filt, gout, gx, B, C, R, H, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace duf

// x (B, C, H, W) fp32; filt (B, 25, R, H, W) fp32 (filt_dtype 0) or bf16
// (1); gout (B, C*R, H, W) fp32; gfilt like filt, or null; gx like x, or
// null. Contiguous; 1 <= C <= 16, B <= 65535. Returns cudaGetLastError()
// after the launches.
extern "C" int duf_bwd(const void* x, const void* filt, const void* gout, void* gfilt,
                       void* gx, int B, int C, int R, int H, int W, int filt_dtype,
                       void* stream) {
  if ((int64_t)B * H * W * R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (filt_dtype == 0) {
    return duf::launch<float>((const float*)x, (const float*)filt, (const float*)gout,
                              (float*)gfilt, (float*)gx, B, C, R, H, W, s);
  }
  return duf::launch<__nv_bfloat16>((const float*)x, (const __nv_bfloat16*)filt,
                                    (const float*)gout, (__nv_bfloat16*)gfilt, (float*)gx, B,
                                    C, R, H, W, s);
}
