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

#include "dcn_bwd_data.cuh"

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
    gather_step<T, kVec, false>(col, x, offset, mask, nullptr, tl, k, c0, C, H, W, inv_w, cg, gk,
                                quads, [](int) {});
    wait_copies();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) contract_w(gt, col, r, acc);
  }
  flush_w<T, kVec>(acc, gw, k, o0, c0, C, Cout);
}

// K2 (dcn_bwd_data.cuh has its body), and its element-by-element form.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dcn_bwd_data_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                    const T* __restrict__ mask, const T* __restrict__ wt,
                    const T* __restrict__ gout, float* __restrict__ gx, T* __restrict__ goff,
                    T* __restrict__ gmask, Geo g, int C, int Cout, int gd, int nitems, int ntg) {
  bwd_data_body<T, false>(x, offset, mask, nullptr, wt, gout, gx, goff, gmask, g, C, Cout, gd,
                          nitems, ntg);
}

template <typename T>
__global__ void __launch_bounds__(256)
dcn_bwd_data_kernel_any(const T* __restrict__ x, const T* __restrict__ offset,
                        const T* __restrict__ mask, const T* __restrict__ wt,
                        const T* __restrict__ gout, float* __restrict__ gx, T* __restrict__ goff,
                        T* __restrict__ gmask, int B, int C, int H, int W, int Cout, int gd) {
  bwd_data_any_body<T, false>(x, offset, mask, nullptr, wt, gout, gx, goff, gmask, B, C, H, W,
                              Cout, gd);
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
    const Geo geo{B, H, W, ntx, tpf, 0, 0};
    const int slots = per_sm * sm_count(), ntg = tap_groups(ntiles, slots);
    const int nitems = ntiles * ntg;
    kernel<<<std::min(nitems, slots), kThreads, smem, stream>>>(
        (const T*)x, (const T*)offset, (const T*)mask, (const T*)wt, (const T*)gout, gcl,
        (T*)goff, (T*)gmask, geo, C, Cout, gd, nitems, ntg);
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
