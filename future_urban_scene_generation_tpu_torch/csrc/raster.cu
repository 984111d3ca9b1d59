// Kernels K1 and K1': z-buffer rasterization of corner-expanded triangles.
//
// Replaces the TPU kernel future_urban_scene_generation_tpu/ops/pallas_raster.py
// (_kernel, reached through rasterize_pallas_corners = K1 and, behind a corner
// gather of an indexed mesh, through rasterize_pallas = K1'; the wrappers are
// ops/cuda_raster.rasterize_corners and rasterize_indexed). Same contract: per-triangle
// affine planes (barycentrics w0..w2, depth, RGB) built by the torch prep
// (ops/cuda_raster.triangle_planes_corners), a pixel is covered when all three
// barycentric planes are >= 0, and the strictly-closer depth test keeps the first
// triangle in buffer order on exact ties (the Pallas kernel averaged ties across
// its 8 partial buffers; the plain raster keeps the first, and so does this).
//
// What bounds it on an H100: per (pixel, binned triangle) pair the work is three
// plane evaluations and a compare, with the triangle's 21 coefficients read by
// every pixel of the tile. At the scene's shapes (24 renders of 1,944 triangles at
// 256^2, about half culled) the kernel touches a few MB: it is latency- and
// issue-bound, not bandwidth-bound.
//
// Design: one block per (render, 16x16 tile), one thread per pixel, depth and
// colour in registers. The tile's bin list (ascending 8-triangle group bases,
// from ops/cuda_raster.bin_groups_for_tiles) is walked in stages of 16 groups:
// the block stages those 128 triangles' coefficients in shared memory, then every
// thread loops over them in order, so each coefficient is read from device memory
// once per tile and from shared memory as a broadcast. Planes are evaluated
// without FMA contraction, ((A*x + B*y) + C) rounded per operation, as the torch
// plain version and the Pallas kernel evaluate them.
#include "fusg_kernels.h"

namespace {

constexpr int kTile = 16;
constexpr int kGroup = 8;
constexpr int kTableCols = 32;
constexpr int kCoefs = 21;
constexpr int kStageGroups = 16;
constexpr int kStageTris = kStageGroups * kGroup;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float plane(const float* c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c[0], x), __fmul_rn(c[1], y)), c[2]);
}

__global__ void __launch_bounds__(kTile * kTile)
raster_kernel(const float* __restrict__ table, const int* __restrict__ bins,
              const int* __restrict__ counts, float* __restrict__ img,
              unsigned char* __restrict__ bg, int t_pad, int n_groups, int h,
              int w, int n_tiles_x) {
  __shared__ float coef[kStageTris][kCoefs];

  const int tile = blockIdx.x;
  const int r = blockIdx.y;
  const int n_tiles = gridDim.x;
  const int px = (tile % n_tiles_x) * kTile + (threadIdx.x % kTile);
  const int py = (tile / n_tiles_x) * kTile + (threadIdx.x / kTile);
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);

  const size_t tile_lin = static_cast<size_t>(r) * n_tiles + tile;
  const int count = counts[tile_lin];
  const int* tile_bins = bins + tile_lin * n_groups;
  const float* tab = table + static_cast<size_t>(r) * t_pad * kTableCols;

  float zbest = kBig;
  float cr = 0.f, cg = 0.f, cb = 0.f;

  for (int start = 0; start < count; start += kStageGroups) {
    const int ng = min(kStageGroups, count - start);
    __syncthreads();  // previous stage fully consumed
    for (int i = threadIdx.x; i < ng * kGroup * kCoefs; i += blockDim.x) {
      const int tri = i / kCoefs;
      const int col = i - tri * kCoefs;
      const int base = tile_bins[start + tri / kGroup];
      coef[tri][col] =
          tab[static_cast<size_t>(base + tri % kGroup) * kTableCols + col];
    }
    __syncthreads();
    const int nt = ng * kGroup;
    for (int t = 0; t < nt; ++t) {
      const float* c = coef[t];
      const float w0 = plane(c + 0, fx, fy);
      const float w1 = plane(c + 3, fx, fy);
      const float w2 = plane(c + 6, fx, fy);
      if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
        const float z = plane(c + 9, fx, fy);
        if (z < zbest) {
          zbest = z;
          cr = plane(c + 12, fx, fy);
          cg = plane(c + 15, fx, fy);
          cb = plane(c + 18, fx, fy);
        }
      }
    }
  }

  if (px < w && py < h) {
    const size_t pix = (static_cast<size_t>(r) * h + py) * w + px;
    const bool background = !(zbest < kBig);
    img[pix * 3 + 0] = background ? 0.f : cr;
    img[pix * 3 + 1] = background ? 0.f : cg;
    img[pix * 3 + 2] = background ? 0.f : cb;
    bg[pix] = background ? 1 : 0;
  }
}

}  // namespace

extern "C" int fusg_raster(const float* table, const int* bins,
                           const int* counts, float* img, unsigned char* bg,
                           int n_renders, int t_pad, int n_groups, int h, int w,
                           int n_tiles_y, int n_tiles_x, cudaStream_t stream) {
  if (n_renders <= 0 || h <= 0 || w <= 0) return 0;
  dim3 grid(n_tiles_y * n_tiles_x, n_renders);
  raster_kernel<<<grid, kTile * kTile, 0, stream>>>(table, bins, counts, img, bg,
                                                    t_pad, n_groups, h, w,
                                                    n_tiles_x);
  return static_cast<int>(cudaGetLastError());
}
