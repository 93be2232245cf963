// Shared pieces of the bilinear warp kernels (warp_fwd.cu, warp_bwd.cu,
// warp_tangent.cu): one sample position's four corners, each with its
// weight and whether it lies inside the frame; the block shape that K5, K11
// and K12 fit to the frame.
//
// Layouts (NCHW planes, contiguous, fp32), the layout the port's TOFlow
// holds inside, so no launch needs a permute copy:
//   x    (B, C, H, W)     the frames that are sampled
//   flow (B, 2, H, W)     plane 0 is dx (horizontal), plane 1 is dy: the
//                         displacement from the output pixel
//   out  (B, C, H, W)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp {

// One sample position. The corner weights come from floor of the
// unclamped position, in fp32, as the JAX function computes them. Whether a
// corner is inside is decided in float before any int conversion, so a
// position far outside the frame (even +-1e30) gives four outside corners
// and never overflows an int.
struct Corners {
  int y0, x0;            // top-left corner (valid only where a flag is set)
  float wy0, wy1, wx0, wx1;
  bool in00, in01, in10, in11;
};

__device__ __forceinline__ Corners make_corners(float ys, float xs, int H, int W) {
  Corners c;
  const float y0f = floorf(ys), x0f = floorf(xs);
  c.wy1 = ys - y0f;
  c.wx1 = xs - x0f;
  c.wy0 = 1.f - c.wy1;
  c.wx0 = 1.f - c.wx1;
  const bool iy0 = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool iy1 = y0f >= -1.f && y0f <= (float)(H - 2);
  const bool ix0 = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool ix1 = x0f >= -1.f && x0f <= (float)(W - 2);
  c.in00 = iy0 && ix0;
  c.in01 = iy0 && ix1;
  c.in10 = iy1 && ix0;
  c.in11 = iy1 && ix1;
  // y0f, x0f lie in [-1, size - 1] wherever a flag is set.
  c.y0 = (iy0 || iy1) ? (int)y0f : 0;
  c.x0 = (ix0 || ix1) ? (int)x0f : 0;
  return c;
}

// The card's SM count, asked once.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, nsm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    return nsm;
  }();
  return n;
}

inline bool aligned8(const void* p) { return (uintptr_t)p % 8 == 0; }

// The block (column groups of `px` pixels x rows) for an H x W frame: as
// narrow as the row allows (8, 16 or 32 groups), then rows halved from 256
// threads a block down to one warp until B frames make at least two blocks
// an SM.
inline void launch_shape(int B, int H, int W, int px, dim3* grid, dim3* block) {
  const int cols = (W + px - 1) / px;
  const int bx = cols >= 64 ? 32 : cols >= 32 ? 16 : 8;
  int by = 256 / bx;
  auto blocks = [&](int y) {
    return (int64_t)((cols + bx - 1) / bx) * ((H + y - 1) / y) * B;
  };
  while (bx * by > 32 && blocks(by) < 2 * sm_count()) by /= 2;
  *block = dim3(bx, by);
  *grid = dim3((cols + bx - 1) / bx, (H + by - 1) / by, B);
}

}  // namespace warp
