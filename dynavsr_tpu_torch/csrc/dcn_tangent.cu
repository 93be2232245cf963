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
// (offsets -> positions -> corners), K10's atomics, and a grid that the
// small frames leave mostly idle.
//
// Design. K8 is K1 with the tangent weight rule and K10 is K2 with it
// (dcn_common.cuh, dcn_fwd.cuh, dcn_bwd_data.cuh; their notes in
// dcn_fwd.cu and dcn_bwd.cu): x channels-last, a sample's 8 channels one
// pair of 16-byte loads a corner, offsets / masks / cotangents loaded 4
// pixels at a time (K8) or staged once a step in shared memory (K10), the
// fp32 products as 8 px x 4 ch register tiles over float4 shared reads,
// weight slices streamed by cp.async; K10's offset and mask gradients are
// summed over each group in shared memory and stored once, without
// atomics, and its grad x is gathered for near samples, with atomics left
// for far samples and corners in another tile. To fill the card at the
// inner step's small frames:
//  - K8's 128-pixel tiles run over the flattened (frame, pixel) index (a
//    tile spans frames; frames padded to 4 pixels, so vector loads stay
//    whole) and a tile's 9 taps are split over 1, 3 or 9 blocks, whichever
//    gives the fewest rounds of steps a block; split s > 0 writes its
//    partial sums to a scratch and a second kernel adds them to the output
//    in split order, so the result is deterministic.
//  - K10's 8 x 16 tiles hold several whole frames where they fit (frames of
//    at most 8 rows and 4, 8 or 16 columns: the 8x8 and 4x4 levels), and
//    K2's tap groups (1, 3 or 9 items a tile) split the taps over blocks;
//    the items' grad x meets in one fp32 scratch by atomics, as in K2.
// K9 keeps PR 9's design (a plain kernel over tangent columns built in
// shared memory, one atomic an entry at the end).
// fp32 only: the meta configs run fp32; a bf16 call raises in the wrapper.
#include <stdint.h>

#include <algorithm>

#include "dcn_bwd_data.cuh"
#include "dcn_fwd.cuh"

namespace dcn {
namespace tng {

// K9: PR 9's design.
constexpr int kTP = 32;   // pixels per tile
constexpr int kTC = 32;   // channels per chunk (one warp's lanes)
constexpr int kTO = 64;   // output channels per block or product step
constexpr int kTT = 256;  // threads per block
constexpr int kRows = kTT / kTC;  // 8 warps: a warp's lanes are the chunk's channels

// The corners of one sample and their tangent weights.
struct Tan {
  int idx[4];   // clamped pixel index of each corner in its plane
  float tw[4];  // coff . d w / d pos, 0 outside the frame
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
  const bool in[4] = {q.y0in && q.x0in, q.y0in && q.x1in, q.y1in && q.x0in, q.y1in && q.x1in};
  Tan t;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    t.idx[c] = q.idx[c];
    t.tw[c] = in[c] ? cy * wy[c] + cx * wx[c] : 0.f;
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


// K8's last pass: out += the partial sums of splits 1 .. nparts, in order.
__global__ void __launch_bounds__(256) sum_parts(float* __restrict__ out,
                                                 const float* __restrict__ part, int64_t n,
                                                 int nparts) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  if (n % 4 == 0) {
    float4* o4 = reinterpret_cast<float4*>(out);
    const float4* p4 = reinterpret_cast<const float4*>(part);
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4; i += step) {
      float4 s = o4[i];
      for (int q = 0; q < nparts; ++q) {
        const float4 v = p4[q * (n / 4) + i];
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      o4[i] = s;
    }
    return;
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    float s = out[i];
    for (int q = 0; q < nparts; ++q) s += part[q * n + i];
    out[i] = s;
  }
}

// K8: K1's body with the tangent rule, on tiles across frames and splits.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dcn_fwd_tangent_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                       const float* __restrict__ mask, const float* __restrict__ coff,
                       const float* __restrict__ wt, float* __restrict__ out,
                       float* __restrict__ part, int B, int C, int H, int W, int Cout, int gd,
                       int stride, int nitems, int nch, int nsplit, int64_t n_out, bool quads) {
  fwd::fwd_body<float, kVec, true>(x, offset, mask, coff, wt, nullptr, out, part, B, C, H, W,
                                   Cout, gd, stride, nitems, nch, nsplit, n_out, quads);
}

// K10: K2's body with the tangent rule, and its element-by-element form.
__global__ void __launch_bounds__(kThreads, 2)
dcn_bwd_data_tangent_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                            const float* __restrict__ mask, const float* __restrict__ coff,
                            const float* __restrict__ wt, const float* __restrict__ gout,
                            float* __restrict__ gx, float* __restrict__ goff,
                            float* __restrict__ gmask, bwd::Geo g, int C, int Cout, int gd,
                            int nitems, int ntg) {
  bwd::bwd_data_body<float, true>(x, offset, mask, coff, wt, gout, gx, goff, gmask, g, C, Cout,
                                  gd, nitems, ntg);
}

__global__ void __launch_bounds__(256)
dcn_bwd_data_tangent_kernel_any(const float* __restrict__ x, const float* __restrict__ offset,
                                const float* __restrict__ mask, const float* __restrict__ coff,
                                const float* __restrict__ wt, const float* __restrict__ gout,
                                float* __restrict__ gx, float* __restrict__ goff,
                                float* __restrict__ gmask, int B, int C, int H, int W, int Cout,
                                int gd) {
  bwd::bwd_data_any_body<float, true>(x, offset, mask, coff, wt, gout, gx, goff, gmask, B, C, H,
                                      W, Cout, gd);
}

// K8's shared memory (K1's kernel with the tangent rule): the column and
// weight rings, 96 KB.
constexpr size_t kFwdSmem = (2 * kP * kCK + 2 * kCK * kN) * sizeof(float);

// K8's geometry: frames padded to 4 pixels, 128-pixel tiles across them.
struct FwdPlan {
  int stride, ntiles, gy, slots;
};

template <bool kVec>
static FwdPlan fwd_plan(int B, int H, int W, int Cout) {
  FwdPlan p;
  p.stride = (H * W + 3) / 4 * 4;
  p.ntiles = (int)(((int64_t)B * p.stride + kP - 1) / kP);
  p.gy = (Cout + kN - 1) / kN;
  static Slots memo[16];
  p.slots = grid_slots(dcn_fwd_tangent_kernel<kVec>, kFwdSmem, memo) / p.gy;
  return p;
}

// Splits of a tile's steps (1, 3 or 9): the fewest rounds of items a block
// walks, each costing its steps, plus one for summing the partials.
static int fwd_splits(const FwdPlan& p, int steps) {
  if (p.slots < 1) return 1;
  int best = 1;
  int64_t cost = -1;
  for (int s = 1; s <= kTaps; s *= 3) {
    const int64_t c = ((int64_t)p.ntiles * s + p.slots - 1) / p.slots * (steps / s) + (s > 1);
    if (cost < 0 || c < cost) cost = c, best = s;
  }
  return best;
}

static bool vec_shape(int C, int gd) { return C % kSeg == 0 && (C / gd) % kSeg == 0; }

template <bool kVec>
static int launch_fwd(const float* x, const float* offset, const float* mask, const float* coff,
                      const float* wt, float* out, float* part, int B, int C, int H, int W,
                      int Cout, int gd, int split, cudaStream_t s) {
  const FwdPlan p = fwd_plan<kVec>(B, H, W, Cout);
  if (p.slots < 1) return (int)cudaErrorInvalidConfiguration;
  const int nch = (C + kCK - 1) / kCK, nitems = p.ntiles * split;
  const int64_t n_out = (int64_t)B * Cout * H * W;
  const bool quads = H * W % 4 == 0 && (uintptr_t)offset % 16 == 0 &&
                     (uintptr_t)mask % 16 == 0 && (uintptr_t)coff % 16 == 0;
  dcn_fwd_tangent_kernel<kVec><<<dim3(std::min(nitems, p.slots), p.gy), kThreads, kFwdSmem, s>>>(
      x, offset, mask, coff, wt, out, part, B, C, H, W, Cout, gd, p.stride, nitems, nch, split,
      n_out, quads);
  if (split > 1) {
    const int64_t blocks = std::min<int64_t>((n_out / 4 + 255) / 256 + 1, 4096);
    sum_parts<<<(unsigned)blocks, 256, 0, s>>>(out, part, n_out, split - 1);
  }
  return (int)cudaGetLastError();
}

// K10's shared memory (K2's kernel with the tangent rule): the grad_out
// tile and weight slot, grad_col, the samples and their (cy, cx), and two
// group sums.
static size_t data_smem(int noc) {
  return (size_t)noc * (bwd::kTP + kCK) * kN * sizeof(float) +
         (bwd::kTP * kCK + bwd::kSums<true> * kSeg * bwd::kSP) * sizeof(float) +
         bwd::kSlots * bwd::kTP * (sizeof(float4) + sizeof(float2));
}

// K10 on the shapes K2's vector path takes: tiles of whole frames where
// they fit, tap groups as K2's (split, or the launcher's choice for 0).
static int launch_data(const float* x, const float* offset, const float* mask,
                       const float* coff, const float* wt, const float* gout, float* gx,
                       float* goff, float* gmask, int B, int C, int H, int W, int Cout, int gd,
                       int split, cudaStream_t s) {
  using bwd::kTH;
  using bwd::kTW;
  const int noc = (Cout + kN - 1) / kN;
  const size_t smem = data_smem(noc);
  auto kernel = dcn_bwd_data_tangent_kernel;
  static Slots memo[16];
  const int slots = grid_slots(kernel, smem, memo);
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  bwd::Geo geo{B, H, W, 1, 1, 0, 0};
  int ntiles;
  if (H <= kTH && (W == 4 || W == 8 || W == 16) && kTH / H * (kTW / W) > 1) {
    geo.fx = kTW / W;  // tiles of fy x fx whole frames
    geo.fy = kTH / H;
    ntiles = (B + geo.fx * geo.fy - 1) / (geo.fx * geo.fy);
  } else {
    geo.ntx = (W + kTW - 1) / kTW;
    geo.tpf = geo.ntx * ((H + kTH - 1) / kTH);
    ntiles = B * geo.tpf;
  }
  const int ntg = split ? split : bwd::tap_groups(ntiles, slots), nitems = ntiles * ntg;
  kernel<<<std::min(nitems, slots), kThreads, smem, s>>>(x, offset, mask, coff, wt, gout, gx,
                                                          goff, gmask, geo, C, Cout, gd, nitems,
                                                          ntg);
  return 0;
}

}  // namespace tng
}  // namespace dcn

// All tensors fp32. x_cl: x channels-last (B, H, W, C); offset, coff (B,
// 2*Gd*9, H, W) and mask (B, Gd*9, H, W, or null) NCHW; wt (9, C, Cout).
// The number of splits of a tile's steps K8 takes at this shape (1, 3 or
// 9): the caller gives dcn_fwd_tangent that many, and a scratch for
// split - 1 partial outputs.
extern "C" int dcn_fwd_tangent_splits(int B, int C, int H, int W, int Cout, int gd) {
  using namespace dcn::tng;
  if (B == 0 || H * W == 0 || Cout == 0) return 1;
  const int steps = dcn::kTaps * ((C + dcn::kCK - 1) / dcn::kCK);
  return vec_shape(C, gd) ? fwd_splits(fwd_plan<true>(B, H, W, Cout), steps)
                          : fwd_splits(fwd_plan<false>(B, H, W, Cout), steps);
}

// out (B, Cout, H, W), needs no initialising; part: (split - 1) * B * Cout
// * H * W floats (null for split 1). Returns cudaGetLastError().
extern "C" int dcn_fwd_tangent(const void* x_cl, const void* offset, const void* mask,
                               const void* coff, const void* wt, void* out, void* part, int B,
                               int C, int H, int W, int Cout, int gd, int split, void* stream) {
  using namespace dcn::tng;
  if (B == 0 || H * W == 0 || Cout == 0) return 0;
  if (split != 1 && split != 3 && split != 9) return (int)cudaErrorInvalidValue;
  auto run = vec_shape(C, gd) ? launch_fwd<true> : launch_fwd<false>;
  return run((const float*)x_cl, (const float*)offset, (const float*)mask, (const float*)coff,
             (const float*)wt, (float*)out, (float*)part, B, C, H, W, Cout, gd, split,
             (cudaStream_t)stream);
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


// wt (9, Cout, C); grad_out (B, Cout, H, W); gx_cl (B, H, W, C), zeroed
// here; goff as offset, gmask as mask (null without a mask), need no
// initialising. split: the tap groups of a tile (1, 3 or 9), 0 for the
// launcher's choice.
extern "C" int dcn_bwd_data_tangent(const void* x_cl, const void* offset, const void* mask,
                                    const void* coff, const void* wt, const void* grad_out,
                                    void* gx_cl, void* goff, void* gmask, int B, int C, int H,
                                    int W, int Cout, int gd, int split, void* stream) {
  using namespace dcn::tng;
  cudaStream_t s = (cudaStream_t)stream;
  const int hw = H * W, cg = C / gd;
  cudaMemsetAsync(gx_cl, 0, sizeof(float) * (size_t)B * hw * C, s);
  if (B == 0 || hw == 0 || C == 0) return (int)cudaGetLastError();
  if (split != 0 && split != 1 && split != 3 && split != 9) return (int)cudaErrorInvalidValue;
  const float *xf = (const float*)x_cl, *of = (const float*)offset, *mf = (const float*)mask,
              *cf = (const float*)coff, *wf = (const float*)wt, *gf = (const float*)grad_out;
  if (C % dcn::kSeg == 0 && cg % dcn::kSeg == 0 && (dcn::kCK % cg == 0 || cg % dcn::kCK == 0) &&
      H <= dcn::bwd::kMaxSide && W <= dcn::bwd::kMaxSide) {
    const int rc = launch_data(xf, of, mf, cf, wf, gf, (float*)gx_cl, (float*)goff,
                               (float*)gmask, B, C, H, W, Cout, gd, split, s);
    if (rc != 0) return rc;
  } else {
    const int64_t threads = (int64_t)B * gd * dcn::kTaps * hw;
    dcn_bwd_data_tangent_kernel_any<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        xf, of, mf, cf, wf, gf, (float*)gx_cl, (float*)goff, (float*)gmask, B, C, H, W, Cout, gd);
  }
  return (int)cudaGetLastError();
}
