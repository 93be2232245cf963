// K8 dcn_fwd_tangent, K9 dcn_bwd_weight_tangent, K10 dcn_bwd_data_tangent:
// the terms of the DCN's second order along an offset cotangent, fp32 and
// bf16, for sm_90a.
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
// Design. K8 is K1 with the tangent weight rule, K9 is K3 with it and K10
// is K2 with it (dcn_common.cuh, dcn_fwd.cuh, dcn_bwd_weight.cuh,
// dcn_bwd_data.cuh; their notes in dcn_fwd.cu and dcn_bwd.cu): x
// channels-last, a sample's 8 channels one pair of 16-byte loads a corner,
// its position and 4 tangent weights computed once for those 8 channels,
// offsets / masks / cotangents loaded 4 pixels at a time (K8, K9) or staged
// once a step in shared memory (K10), the fp32 products as register tiles
// over float4 shared reads (8 px x 4 ch in K8 / K10, 4 o x 4 c in K9),
// weight slices (K8, K10) and grad_out tiles (K9) streamed by cp.async;
// K9 flushes its sums once a block with float4 atomics into a (9, Cout,
// C) scratch that a second kernel writes out as OIHW; K10's offset and
// mask gradients are summed over each group in shared memory and stored
// once, without atomics, and its grad x is gathered for near samples, with
// atomics left for far samples and corners in another tile. To fill the
// card at the inner step's small frames:
//  - K8's and K9's 128-pixel tiles run over the flattened (frame, pixel)
//    index (a tile spans frames; frames padded to 4 pixels, so vector loads
//    stay whole, and the padding's pixels give exact zeros). K8 splits a
//    tile's 9 taps over 1, 3 or 9 blocks, whichever gives the fewest rounds
//    of steps a block; split s > 0 writes its partial sums to a scratch and
//    a second kernel adds them to the output in split order, so the result
//    is deterministic. K9 gives each tap its own blocks, as K3 does: at
//    40 x 8x8 that is 20 tiles x 9 = 180 blocks, at 4x4 5 x 9 = 45.
//  - K10's 8 x 16 tiles hold several whole frames where they fit (frames of
//    at most 8 rows and 4, 8 or 16 columns: the 8x8 and 4x4 levels), and
//    K2's tap groups (1, 3 or 9 items a tile) split the taps over blocks;
//    the items' grad x meets in one fp32 scratch by atomics, as in K2.
//
// bf16 (an EDVR net in bf16 meta-trained to second order, as EDVR-L's
// configs run it): the same bodies at T = bf16, K1-K3's bf16 paths with the
// tangent rule. The function is JAX's bf16 autodiff of the fused kernel, at
// K1-K3's rounding points: the tangent columns are formed in fp32 from the
// bf16 x, offsets, masks and cotangents and rounded to bf16 for the
// tensor-core products (K8 against the bf16 weight, K9 against the bf16
// grad_out), as K1 rounds its columns; K10's gc = W^T . grad_out is an fp32
// product of bf16 operands kept in fp32, as in K2. Every sum, scratch and
// atomic is fp32 (K8's split partial sums too: each split writes fp32 and
// the last pass adds them in order and rounds once), and the outputs are in
// x's dtype (K10's grad x is summed into an fp32 channels-last scratch and
// written out once as bf16). K10 loads its samples at each step as fp32
// does: K2's bf16 staging a step ahead holds one frame's offsets and masks,
// not the cotangents or the whole-frame tiles. K9's flat tiles pad frames
// to 8 pixels in bf16, so a 16-byte grad_out chunk never straddles two.
#include <stdint.h>

#include <algorithm>

#include "dcn_bwd_data.cuh"
#include "dcn_bwd_weight.cuh"
#include "dcn_fwd.cuh"

namespace dcn {
namespace tng {

// K8's last pass: out += the partial sums of splits 1 .. nparts, in order
// (fp32), or out = the sum of splits 0 .. nparts - 1 rounded once (bf16).
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

__global__ void __launch_bounds__(256) sum_parts(__nv_bfloat16* __restrict__ out,
                                                 const float* __restrict__ part, int64_t n,
                                                 int nparts) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  if (n % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4; i += step) {
      float4 s = p4[i];
      for (int q = 1; q < nparts; ++q) {
        const float4 v = p4[q * (n / 4) + i];
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      *reinterpret_cast<uint2*>(out + 4 * i) = make_uint2(pack_bf16(s.x, s.y),
                                                          pack_bf16(s.z, s.w));
    }
    return;
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    float s = part[i];
    for (int q = 1; q < nparts; ++q) s += part[q * n + i];
    out[i] = __float2bfloat16(s);
  }
}

// K10's last pass in bf16: the fp32 grad x scratch out in bf16.
__global__ void __launch_bounds__(256) to_bf16(const float* __restrict__ s,
                                               __nv_bfloat16* __restrict__ out, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    out[i] = __float2bfloat16(s[i]);
}

// K8: K1's body with the tangent rule, on tiles across frames and splits.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dcn_fwd_tangent_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                       const T* __restrict__ mask, const T* __restrict__ coff,
                       const T* __restrict__ wt, T* __restrict__ out,
                       float* __restrict__ part, int B, int C, int H, int W, int Cout, int gd,
                       int stride, int nitems, int nch, int nsplit, int64_t n_out, bool quads) {
  fwd::fwd_body<T, kVec, true>(x, offset, mask, coff, wt, nullptr, out, part, B, C, H, W, Cout,
                               gd, stride, nitems, nch, nsplit, n_out, quads);
}

// K9: K3's body with the tangent rule, on tiles across frames.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dcn_bwd_weight_tangent_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                              const T* __restrict__ mask, const T* __restrict__ coff,
                              const T* __restrict__ gout, float* __restrict__ gw, int B,
                              int C, int H, int W, int Cout, int gd, int stride, int ntiles,
                              int c_tiles, bool quads, bool gvec) {
  bwd::bwd_weight_body<T, kVec, true>(x, offset, mask, coff, gout, gw, B, C, H, W, Cout, gd,
                                      stride, ntiles, c_tiles, quads, gvec);
}

// K9's last pass: its (9, Cout, C) scratch out as (Cout, C, 3, 3).
template <typename T>
__global__ void __launch_bounds__(256)
gw_tangent_to_oihw(const float* __restrict__ s, T* __restrict__ gw, int Cout, int C) {
  bwd::scratch_to_oihw(s, gw, Cout, C);
}

// K10: K2's body with the tangent rule, and its element-by-element form.
// grad x is summed into gx, an fp32 channels-last scratch.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dcn_bwd_data_tangent_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                            const T* __restrict__ mask, const T* __restrict__ coff,
                            const T* __restrict__ wt, const T* __restrict__ gout,
                            float* __restrict__ gx, T* __restrict__ goff,
                            T* __restrict__ gmask, bwd::Geo g, int C, int Cout, int gd,
                            int nitems, int ntg) {
  bwd::bwd_data_body<T, true>(x, offset, mask, coff, wt, gout, gx, goff, gmask, g, C, Cout, gd,
                              nitems, ntg);
}

template <typename T>
__global__ void __launch_bounds__(256)
dcn_bwd_data_tangent_kernel_any(const T* __restrict__ x, const T* __restrict__ offset,
                                const T* __restrict__ mask, const T* __restrict__ coff,
                                const T* __restrict__ wt, const T* __restrict__ gout,
                                float* __restrict__ gx, T* __restrict__ goff,
                                T* __restrict__ gmask, int B, int C, int H, int W, int Cout,
                                int gd) {
  bwd::bwd_data_any_body<T, true>(x, offset, mask, coff, wt, gout, gx, goff, gmask, B, C, H, W,
                                  Cout, gd);
}

// K8's shared memory (K1's kernel with the tangent rule): the column and
// weight rings, 96 KB in fp32, 48 KB in bf16.
template <typename T>
constexpr size_t kFwdSmem = (2 * kP * kCK + 2 * kCK * kN) * sizeof(T);

// K8's geometry: frames padded to 4 pixels, 128-pixel tiles across them.
struct FwdPlan {
  int stride, ntiles, gy, slots;
};

template <typename T, bool kVec>
static FwdPlan fwd_plan(int B, int H, int W, int Cout) {
  FwdPlan p;
  p.stride = (H * W + 3) / 4 * 4;
  p.ntiles = (int)(((int64_t)B * p.stride + kP - 1) / kP);
  p.gy = (Cout + kN - 1) / kN;
  static Slots memo[16];
  p.slots = grid_slots(dcn_fwd_tangent_kernel<T, kVec>, kFwdSmem<T>, memo) / p.gy;
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

template <typename T>
static int splits(int B, int C, int H, int W, int Cout, int gd) {
  const int steps = kTaps * ((C + kCK - 1) / kCK);
  return vec_shape(C, gd) ? fwd_splits(fwd_plan<T, true>(B, H, W, Cout), steps)
                          : fwd_splits(fwd_plan<T, false>(B, H, W, Cout), steps);
}

template <typename T, bool kVec>
static int launch_fwd(const T* x, const T* offset, const T* mask, const T* coff, const T* wt,
                      T* out, float* part, int B, int C, int H, int W, int Cout, int gd,
                      int split, cudaStream_t s) {
  const FwdPlan p = fwd_plan<T, kVec>(B, H, W, Cout);
  if (p.slots < 1) return (int)cudaErrorInvalidConfiguration;
  const int nch = (C + kCK - 1) / kCK, nitems = p.ntiles * split;
  const int64_t n_out = (int64_t)B * Cout * H * W;
  const bool quads = H * W % 4 == 0 && (uintptr_t)offset % 16 == 0 &&
                     (uintptr_t)mask % 16 == 0 && (uintptr_t)coff % 16 == 0;
  dcn_fwd_tangent_kernel<T, kVec>
      <<<dim3(std::min(nitems, p.slots), p.gy), kThreads, kFwdSmem<T>, s>>>(
          x, offset, mask, coff, wt, out, part, B, C, H, W, Cout, gd, p.stride, nitems, nch,
          split, n_out, quads);
  if (split > 1) {
    const int64_t blocks = std::min<int64_t>((n_out / 4 + 255) / 256 + 1, 4096);
    // fp32: splits 1.. into out; bf16: all of them, rounded once.
    sum_parts<<<(unsigned)blocks, 256, 0, s>>>(out, part, n_out,
                                               sizeof(T) == 4 ? split - 1 : split);
  }
  return (int)cudaGetLastError();
}

// K10's shared memory (K2's kernel with the tangent rule): the grad_out
// tile and weight slot (in x's dtype), grad_col, the samples and their (cy,
// cx), and two group sums.
template <typename T>
static size_t data_smem(int noc) {
  return (size_t)noc * (bwd::kTP + kCK) * kN * sizeof(T) +
         (bwd::kTP * kCK + bwd::kSums<true> * kSeg * bwd::kSP) * sizeof(float) +
         bwd::kSlots * bwd::kTP * (sizeof(float4) + sizeof(float2));
}

// K10 on the shapes K2's vector path takes: tiles of whole frames where
// they fit, tap groups as K2's (split, or the launcher's choice for 0).
template <typename T>
static int launch_data(const T* x, const T* offset, const T* mask, const T* coff, const T* wt,
                       const T* gout, float* gx, T* goff, T* gmask, int B, int C, int H, int W,
                       int Cout, int gd, int split, cudaStream_t s) {
  using bwd::kTH;
  using bwd::kTW;
  const int noc = (Cout + kN - 1) / kN;
  const size_t smem = data_smem<T>(noc);
  auto kernel = dcn_bwd_data_tangent_kernel<T>;
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

// K9: the grad_out and column tiles (K3's), 64 KB in fp32, 32 KB in bf16.
template <typename T>
constexpr size_t kWeightSmem = (kP * kCK + kN * kP) * sizeof(T);

// K9 on the flat tiles of K8 (frames padded to 4 pixels in fp32, 8 in
// bf16), one block a (tap, channel chunk, out-chunk) and a share of the
// tiles, as many blocks as the card holds at once; gsc the (9, Cout, C)
// scratch, zeroed before.
template <typename T, bool kVec>
static int launch_weight(const T* x, const T* offset, const T* mask, const T* coff,
                         const T* gout, float* gsc, int B, int C, int H, int W, int Cout, int gd,
                         cudaStream_t s) {
  constexpr int kE = 16 / (int)sizeof(T);  // pixels of a 16-byte grad_out chunk
  auto kernel = dcn_bwd_weight_tangent_kernel<T, kVec>;
  static Slots memo[16];
  const int slots = grid_slots(kernel, kWeightSmem<T>, memo);
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const int hw = H * W, stride = (hw + kE - 1) / kE * kE;
  const int ntiles = (int)(((int64_t)B * stride + kP - 1) / kP);
  const int c_tiles = (C + kCK - 1) / kCK, gy = kTaps * c_tiles * ((Cout + kN - 1) / kN);
  const int gxn = std::min(ntiles, std::max(1, slots / gy));
  const bool quads = hw % 4 == 0 && (uintptr_t)offset % 16 == 0 &&
                     (uintptr_t)mask % 16 == 0 && (uintptr_t)coff % 16 == 0;
  const bool gvec = hw % kE == 0 && (uintptr_t)gout % 16 == 0;
  kernel<<<dim3(gxn, gy), kThreads, kWeightSmem<T>, s>>>(x, offset, mask, coff, gout, gsc, B, C,
                                                         H, W, Cout, gd, stride, ntiles, c_tiles,
                                                         quads, gvec);
  return 0;
}

template <typename T>
static int fwd_tangent(const void* x_cl, const void* offset, const void* mask, const void* coff,
                       const void* wt, void* out, void* part, int B, int C, int H, int W,
                       int Cout, int gd, int split, cudaStream_t s) {
  auto run = vec_shape(C, gd) ? launch_fwd<T, true> : launch_fwd<T, false>;
  return run((const T*)x_cl, (const T*)offset, (const T*)mask, (const T*)coff, (const T*)wt,
             (T*)out, (float*)part, B, C, H, W, Cout, gd, split, s);
}

template <typename T>
static int bwd_weight_tangent(const void* x_cl, const void* offset, const void* mask,
                              const void* coff, const void* grad_out, float* gsc, void* gw,
                              int B, int C, int H, int W, int Cout, int gd, cudaStream_t s) {
  const int n = kTaps * Cout * C;
  cudaMemsetAsync(gsc, 0, sizeof(float) * (size_t)n, s);
  if (B > 0 && H * W > 0) {
    auto run = vec_shape(C, gd) ? launch_weight<T, true> : launch_weight<T, false>;
    const int rc = run((const T*)x_cl, (const T*)offset, (const T*)mask, (const T*)coff,
                       (const T*)grad_out, gsc, B, C, H, W, Cout, gd, s);
    if (rc != 0) return rc;
  }
  gw_tangent_to_oihw<T><<<std::max(1, std::min((n + 255) / 256, 1024)), 256, 0, s>>>(
      gsc, (T*)gw, Cout, C);
  return (int)cudaGetLastError();
}

template <typename T>
static int bwd_data_tangent(const void* x_cl, const void* offset, const void* mask,
                            const void* coff, const void* wt, const void* grad_out, float* gsc,
                            void* goff, void* gmask, int B, int C, int H, int W, int Cout,
                            int gd, int split, cudaStream_t s) {
  const int hw = H * W, cg = C / gd;
  cudaMemsetAsync(gsc, 0, sizeof(float) * (size_t)B * hw * C, s);
  if (B == 0 || hw == 0 || C == 0) return (int)cudaGetLastError();
  const T *xf = (const T*)x_cl, *of = (const T*)offset, *mf = (const T*)mask,
          *cf = (const T*)coff, *wf = (const T*)wt, *gf = (const T*)grad_out;
  if (C % kSeg == 0 && cg % kSeg == 0 && (kCK % cg == 0 || cg % kCK == 0) &&
      H <= bwd::kMaxSide && W <= bwd::kMaxSide) {
    return launch_data<T>(xf, of, mf, cf, wf, gf, gsc, (T*)goff, (T*)gmask, B, C, H, W, Cout,
                          gd, split, s);
  }
  const int64_t threads = (int64_t)B * gd * kTaps * hw;
  dcn_bwd_data_tangent_kernel_any<T><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      xf, of, mf, cf, wf, gf, gsc, (T*)goff, (T*)gmask, B, C, H, W, Cout, gd);
  return 0;
}

}  // namespace tng
}  // namespace dcn

// dtype: 0 = float32, 1 = bfloat16 for x_cl, offset, mask, coff, wt,
// grad_out and the outputs; scratches are fp32. x_cl: x channels-last (B,
// H, W, C); offset, coff (B, 2*Gd*9, H, W) and mask (B, Gd*9, H, W, or
// null) NCHW.
// The number of splits of a tile's steps K8 takes at this shape (1, 3 or
// 9): the caller gives dcn_fwd_tangent that many, and its fp32 scratch.
extern "C" int dcn_fwd_tangent_splits(int B, int C, int H, int W, int Cout, int gd,
                                      int dtype) {
  using namespace dcn::tng;
  if (B == 0 || H * W == 0 || Cout == 0) return 1;
  return dtype == 1 ? splits<__nv_bfloat16>(B, C, H, W, Cout, gd)
                    : splits<float>(B, C, H, W, Cout, gd);
}

// wt: fp32 (9, C, Cout), bf16 (9, Cout, C) (K1's layouts); out (B, Cout, H,
// W), needs no initialising; part: fp32 scratch of (split - 1) * B * Cout
// * H * W floats in fp32, split * that in bf16 (null for split 1). Returns
// cudaGetLastError().
extern "C" int dcn_fwd_tangent(const void* x_cl, const void* offset, const void* mask,
                               const void* coff, const void* wt, void* out, void* part, int B,
                               int C, int H, int W, int Cout, int gd, int split, int dtype,
                               void* stream) {
  using namespace dcn::tng;
  if (B == 0 || H * W == 0 || Cout == 0) return 0;
  if (split != 1 && split != 3 && split != 9) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return fwd_tangent<float>(x_cl, offset, mask, coff, wt, out, part, B, C, H, W, Cout, gd,
                              split, s);
  if (dtype == 1)
    return fwd_tangent<__nv_bfloat16>(x_cl, offset, mask, coff, wt, out, part, B, C, H, W,
                                      Cout, gd, split, s);
  return (int)cudaErrorInvalidValue;
}

// grad_out (B, Cout, H, W); gsc: fp32 scratch of 9*Cout*C; gw (Cout, C, 3,
// 3), needs no initialising.
extern "C" int dcn_bwd_weight_tangent(const void* x_cl, const void* offset, const void* mask,
                                      const void* coff, const void* grad_out, void* gsc, void* gw,
                                      int B, int C, int H, int W, int Cout, int gd, int dtype,
                                      void* stream) {
  using namespace dcn::tng;
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout == 0 || C == 0) return 0;
  if (dtype == 0)
    return bwd_weight_tangent<float>(x_cl, offset, mask, coff, grad_out, (float*)gsc, gw, B, C,
                                     H, W, Cout, gd, s);
  if (dtype == 1)
    return bwd_weight_tangent<__nv_bfloat16>(x_cl, offset, mask, coff, grad_out, (float*)gsc,
                                             gw, B, C, H, W, Cout, gd, s);
  return (int)cudaErrorInvalidValue;
}

// wt: fp32 (9, Cout, C), bf16 (9, C, Cout) (K2's layouts); grad_out (B,
// Cout, H, W); gsc: fp32 (B, H, W, C), zeroed here, into which grad x is
// summed: in fp32 it is the output (gx_cl unused), in bf16 the launcher
// writes it out into gx_cl (B, H, W, C); goff as offset, gmask as mask
// (null without a mask), need no initialising. split: the tap groups of a
// tile (1, 3 or 9), 0 for the launcher's choice.
extern "C" int dcn_bwd_data_tangent(const void* x_cl, const void* offset, const void* mask,
                                    const void* coff, const void* wt, const void* grad_out,
                                    void* gsc, void* gx_cl, void* goff, void* gmask, int B, int C,
                                    int H, int W, int Cout, int gd, int split, int dtype,
                                    void* stream) {
  using namespace dcn::tng;
  cudaStream_t s = (cudaStream_t)stream;
  if (split != 0 && split != 1 && split != 3 && split != 9) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0) {
    rc = bwd_data_tangent<float>(x_cl, offset, mask, coff, wt, grad_out, (float*)gsc, goff,
                                 gmask, B, C, H, W, Cout, gd, split, s);
  } else if (dtype == 1) {
    rc = bwd_data_tangent<__nv_bfloat16>(x_cl, offset, mask, coff, wt, grad_out, (float*)gsc,
                                         goff, gmask, B, C, H, W, Cout, gd, split, s);
    const int64_t n = (int64_t)B * H * W * C;
    if (rc == 0 && n > 0)
      to_bf16<<<(unsigned)std::max<int64_t>(1, std::min<int64_t>((n + 255) / 256, 4096)), 256,
                0, s>>>((const float*)gsc, (__nv_bfloat16*)gx_cl, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
