// Kernels K1 and K1': z-buffer rasterization of triangles, batched over renders.
//
// Replaces the whole of the TPU package's
// future_urban_scene_generation_tpu/ops/pallas_raster.py rasterize_pallas_corners
// (K1: prep :119, binning :235, kernel :279, resolve :429) and rasterize_pallas
// (K1': an indexed mesh whose corners are gathered in front of the same kernel).
// The wrappers are ops/cuda_raster.rasterize_corners and rasterize_indexed. Same
// contract: per-triangle affine planes (barycentrics w0..w2, depth, RGB), a pixel
// is covered when all three barycentric planes are >= 0, and the strictly-closer
// depth test keeps the first triangle in buffer order on exact ties (the Pallas
// kernel averaged ties across its 8 partial buffers; the plain raster keeps the
// first, and so does this).
//
// What bounds it on an H100: the inputs and the image are a few MB and the plane
// evaluations a few hundred MFLOP, so the card could do the work in ~10 us; what
// costs time is the number of launches in front of the raster and, inside it, the
// triangles a pixel evaluates that cannot touch it. The design therefore is two
// launches and no intermediate tensor whose size depends on the data:
//
// 1. raster_setup_kernel, one thread per triangle (T is the innermost axis of the
//    (R, 3, 3, T) inputs, so the 18 loads are coalesced; the indexed entry is the
//    same kernel with a loader that reads three vertex indices and gathers). It
//    writes the triangle's 128-byte table row (ops/cuda_raster.py names the
//    columns) with every operation of ops/cuda_raster.triangle_planes_corners in
//    the same order and rounded on its own (_rn intrinsics, an IEEE division), so
//    the table equals the torch prep's bit for bit; the triangle's own screen bbox;
//    and the bbox of its 8-triangle group by a min/max shuffle over the group's 8
//    lanes, into the row and into a compact (R, G, 4) array.
// 2. raster_tiles_kernel, one block per (render, 16x16 tile), one thread per pixel,
//    depth and colour in registers. The block bins for itself: in passes of 256
//    groups, thread g tests group g's bbox against the tile; a ballot, a popcount
//    and a prefix over the 8 warps give each hit its slot, ascending. The pass's
//    hits are consumed 16 groups at a time: 128 threads test each triangle's own
//    bbox (the same test, the same compaction, order kept), the surviving rows are
//    staged whole in shared memory by 16-byte cp.async, and every thread walks them
//    in order; a warp (2 rows of the tile) skips a triangle whose bbox misses its
//    rows (a warp-uniform branch). No list is longer than a pass. Planes are
//    evaluated without FMA contraction, ((A*x + B*y) + C) rounded per operation,
//    as the plain version and the Pallas kernel evaluate them. The tile's colours
//    leave through shared memory as 16-byte vectors.
#include "fusg_kernels.h"

namespace {

constexpr int kTile = 16;
constexpr int kGroup = 8;
constexpr int kCols = 32;       // floats in a table row
constexpr int kTriBoxCol = 28;  // the triangle's bbox (x0, x1, y0, y1): a 16-byte vector
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kPassGroups = kThreads;  // groups tested per binning pass
constexpr int kStageGroups = 16;       // hit groups consumed per stage
constexpr int kStageTris = kStageGroups * kGroup;
constexpr float kBig = 1e30f;

// ---------------------------------------------------------------- triangle setup

struct Tri {
  float x[3], y[3], z[3];  // per corner
  float c[3][3];           // colour [corner][component]
};

// K1: corner-expanded (R, 3 corners, 3 components, T) screen and colour tensors.
struct CornerLoader {
  const float* screen;
  const float* colors;
  const unsigned char* cull;  // (R,) or null
  int n_tris;

  __device__ bool culls(int r) const { return cull != nullptr && cull[r] != 0; }
  __device__ void load(int r, int t, Tri& v) const {
    const size_t base = static_cast<size_t>(r) * 9 * n_tris + t;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v.x[k] = screen[base + static_cast<size_t>(k * 3 + 0) * n_tris];
      v.y[k] = screen[base + static_cast<size_t>(k * 3 + 1) * n_tris];
      v.z[k] = screen[base + static_cast<size_t>(k * 3 + 2) * n_tris];
#pragma unroll
      for (int m = 0; m < 3; ++m)
        v.c[k][m] = colors[base + static_cast<size_t>(k * 3 + m) * n_tris];
    }
  }
};

// K1': per-vertex (R, Nv, 3) screen and colour rows behind (T, 3) or (R, T, 3)
// vertex indices. An index outside [0, Nv) is clamped, as the TPU package's gather
// clamps it. An indexed mesh carries no cull flag.
template <typename Index>
struct IndexedLoader {
  const float* verts;
  const float* colors;
  const Index* tris;
  int n_verts;
  int n_tris;
  int batched;  // 1: tris is (R, T, 3)

  __device__ bool culls(int) const { return false; }
  __device__ void load(int r, int t, Tri& v) const {
    const Index* tri =
        tris + (static_cast<size_t>(batched ? r : 0) * n_tris + t) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      long long i = static_cast<long long>(tri[k]);
      i = i < 0 ? 0 : (i >= n_verts ? n_verts - 1 : i);
      const size_t row = (static_cast<size_t>(r) * n_verts + i) * 3;
      v.x[k] = verts[row + 0];
      v.y[k] = verts[row + 1];
      v.z[k] = verts[row + 2];
#pragma unroll
      for (int m = 0; m < 3; ++m) v.c[k][m] = colors[row + m];
    }
  }
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Barycentric plane of the edge a -> b, scaled by 1 / area: (A, B, C).
__device__ __forceinline__ void edge_plane(float ax, float ay, float bx, float by,
                                           float inv_area, float* out) {
  const float dy = sub(by, ay);
  const float dx = sub(bx, ax);
  out[0] = mul(-dy, inv_area);
  out[1] = mul(dx, inv_area);
  out[2] = mul(sub(mul(dy, ax), mul(dx, ay)), inv_area);
}

template <typename Loader>
__global__ void __launch_bounds__(kThreads)
raster_setup_kernel(Loader loader, float* __restrict__ table,
                    float4* __restrict__ gbbox, int n_tris, int t_pad) {
  const int r = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;

  // A row past T (up to the group multiple) is an invalid triangle: zero planes
  // under a constant -1 w0 plane, an empty bbox.
  float w[9] = {0.f, 0.f, -1.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float q[12] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float bx0 = kBig, bx1 = -kBig, by0 = kBig, by1 = -kBig;

  if (t < n_tris) {
    Tri v;
    loader.load(r, t, v);
    const float area = sub(mul(sub(v.x[1], v.x[0]), sub(v.y[2], v.y[0])),
                           mul(sub(v.y[1], v.y[0]), sub(v.x[2], v.x[0])));
    bool valid = v.z[0] > 1e-6f && v.z[1] > 1e-6f && v.z[2] > 1e-6f &&
                 fabsf(area) > 1e-12f;
    if (loader.culls(r)) valid = valid && area < 0.f;
    const float safe_area = fabsf(area) < 1e-12f ? 1.f : area;
    const float inv_area = valid ? __fdiv_rn(1.f, safe_area) : 0.f;

    edge_plane(v.x[1], v.y[1], v.x[2], v.y[2], inv_area, w + 0);
    edge_plane(v.x[2], v.y[2], v.x[0], v.y[0], inv_area, w + 3);
    edge_plane(v.x[0], v.y[0], v.x[1], v.y[1], inv_area, w + 6);
    // Depth and colour planes: (w0 * q0 + w1 * q1) + w2 * q2 per coefficient.
    const float at[3][4] = {{v.z[0], v.c[0][0], v.c[0][1], v.c[0][2]},
                            {v.z[1], v.c[1][0], v.c[1][1], v.c[1][2]},
                            {v.z[2], v.c[2][0], v.c[2][1], v.c[2][2]}};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        q[p * 3 + k] = add(add(mul(w[k], at[0][p]), mul(w[3 + k], at[1][p])),
                           mul(w[6 + k], at[2][p]));
    }
    if (valid) {
      bx0 = fminf(fminf(v.x[0], v.x[1]), v.x[2]);
      bx1 = fmaxf(fmaxf(v.x[0], v.x[1]), v.x[2]);
      by0 = fminf(fminf(v.y[0], v.y[1]), v.y[2]);
      by1 = fmaxf(fmaxf(v.y[0], v.y[1]), v.y[2]);
    } else {
      w[0] = 0.f;
      w[1] = 0.f;
      w[2] = -1.f;
    }
  }

  // The group's bbox: min / max over its 8 lanes (a block starts at a multiple of
  // 8 triangles, so a group never straddles a warp). Every lane takes part.
  float gx0 = bx0, gx1 = bx1, gy0 = by0, gy1 = by1;
#pragma unroll
  for (int d = 1; d < kGroup; d <<= 1) {
    gx0 = fminf(gx0, __shfl_xor_sync(0xffffffffu, gx0, d));
    gx1 = fmaxf(gx1, __shfl_xor_sync(0xffffffffu, gx1, d));
    gy0 = fminf(gy0, __shfl_xor_sync(0xffffffffu, gy0, d));
    gy1 = fmaxf(gy1, __shfl_xor_sync(0xffffffffu, gy1, d));
  }

  if (t >= t_pad) return;
  float4* row = reinterpret_cast<float4*>(
      table + (static_cast<size_t>(r) * t_pad + t) * kCols);
  row[0] = make_float4(w[0], w[1], w[2], w[3]);
  row[1] = make_float4(w[4], w[5], w[6], w[7]);
  row[2] = make_float4(w[8], q[0], q[1], q[2]);
  row[3] = make_float4(q[3], q[4], q[5], q[6]);
  row[4] = make_float4(q[7], q[8], q[9], q[10]);
  row[5] = make_float4(q[11], gx0, gx1, gy0);
  row[6] = make_float4(gy1, 0.f, 0.f, 0.f);
  row[7] = make_float4(bx0, bx1, by0, by1);
  if ((t & (kGroup - 1)) == 0)
    gbbox[static_cast<size_t>(r) * (t_pad / kGroup) + t / kGroup] =
        make_float4(gx0, gx1, gy0, gy1);
}

// ------------------------------------------------------------------ tile raster

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// The binning test of ops/cuda_raster.bin_groups_for_tiles: a bbox (x0, x1, y0, y1)
// against the pixel centres of the tile whose first pixel is (tx, ty).
__device__ __forceinline__ bool box_hits_tile(const float4 b, float tx, float ty) {
  return b.y >= tx && b.x <= tx + (kTile - 1) && b.w >= ty && b.z <= ty + (kTile - 1);
}

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// The slot of this thread's hit among the block's hits, ascending by thread:
// `ballot` is the warp's hit mask, `warp_counts` 8 ints of shared memory. Holds one
// barrier; the caller places another before `warp_counts` is written again.
__device__ __forceinline__ int ordered_slot(unsigned ballot, int* warp_counts) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int slot = __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
  for (int i = 0; i < kWarps; ++i)
    if (i < warp) slot += warp_counts[i];
  return slot;
}

// Five blocks an SM leave a thread 48 registers (without the second bound ptxas
// holds the kernel to 40 and spills).
__global__ void __launch_bounds__(kThreads, 5)
raster_tiles_kernel(const float* __restrict__ table, const float4* __restrict__ gbbox,
                    float* __restrict__ img, unsigned char* __restrict__ bg,
                    int* __restrict__ tile_counts, int t_pad, int n_groups, int h,
                    int w, int n_tiles_x) {
  __shared__ __align__(16) float s_coef[kStageTris * kCols];
  __shared__ int s_groups[kPassGroups];
  __shared__ int s_tris[kStageTris];
  __shared__ int s_warp[kWarps];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int r = blockIdx.y;
  const int tx0 = (tile % n_tiles_x) * kTile;
  const int ty0 = (tile / n_tiles_x) * kTile;
  const int px = tx0 + (tid % kTile);
  const int py = ty0 + (tid / kTile);
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const float ftx = static_cast<float>(tx0);
  const float fty = static_cast<float>(ty0);
  const float wy0 = static_cast<float>(ty0 + 2 * (tid >> 5));  // the warp's rows:
  const float wy1 = wy0 + 1.f;                                 // wy0 and wy0 + 1

  const float* tab = table + static_cast<size_t>(r) * t_pad * kCols;
  const float4* gb = gbbox + static_cast<size_t>(r) * n_groups;

  float zbest = kBig;
  float cr = 0.f, cg = 0.f, cb = 0.f;
  int group_hits = 0, tri_hits = 0;

  for (int base = 0; base < n_groups; base += kPassGroups) {
    const int g = base + tid;
    const bool hit = g < n_groups && box_hits_tile(gb[g], ftx, fty);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    const int n_hit = __syncthreads_count(hit);
    if (n_hit == 0) continue;  // the same for every thread of the block
    const int slot = ordered_slot(ballot, s_warp);
    if (hit) s_groups[slot] = g;
    __syncthreads();
    group_hits += n_hit;

    for (int start = 0; start < n_hit; start += kStageGroups) {
      // Triangle level: thread i takes triangle i % 8 of the stage's group i / 8.
      const int n_cand = min(kStageGroups, n_hit - start) * kGroup;
      int row = 0;
      bool tri_hit = false;
      if (tid < n_cand) {
        row = s_groups[start + tid / kGroup] * kGroup + (tid % kGroup);
        const float4 b = *reinterpret_cast<const float4*>(
            tab + static_cast<size_t>(row) * kCols + kTriBoxCol);
        tri_hit = box_hits_tile(b, ftx, fty);
      }
      const unsigned tri_ballot = __ballot_sync(0xffffffffu, tri_hit);
      // This barrier also ends the previous stage's reads of s_coef and s_tris.
      const int n_t = __syncthreads_count(tri_hit);
      if (n_t == 0) continue;
      const int tri_slot = ordered_slot(tri_ballot, s_warp);
      if (tri_hit) s_tris[tri_slot] = row;
      __syncthreads();
      tri_hits += n_t;

      // Stage the surviving rows whole: 8 x 16 bytes each.
      for (int i = tid; i < n_t * (kCols / 4); i += kThreads)
        cp_async16(s_coef + i * 4,
                   tab + static_cast<size_t>(s_tris[i >> 3]) * kCols + (i & 7) * 4);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();

      for (int t = 0; t < n_t; ++t) {
        const float4* c = reinterpret_cast<const float4*>(s_coef + t * kCols);
        const float4 box = c[7];
        if (!(box.w >= wy0 && box.z <= wy1)) continue;  // misses the warp's rows
        const float4 c0 = c[0], c1 = c[1], c2 = c[2];
        const float w0 = plane(c0.x, c0.y, c0.z, fx, fy);
        const float w1 = plane(c0.w, c1.x, c1.y, fx, fy);
        const float w2 = plane(c1.z, c1.w, c2.x, fx, fy);
        if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
          const float z = plane(c2.y, c2.z, c2.w, fx, fy);
          if (z < zbest) {
            const float4 c3 = c[3], c4 = c[4];
            zbest = z;
            cr = plane(c3.x, c3.y, c3.z, fx, fy);
            cg = plane(c3.w, c4.x, c4.y, fx, fy);
            cb = plane(c4.z, c4.w, c[5].x, fx, fy);
          }
        }
      }
    }
  }

  if (tile_counts != nullptr && tid == 0) {
    int* out = tile_counts + (static_cast<size_t>(r) * gridDim.x + tile) * 2;
    out[0] = group_hits;
    out[1] = tri_hits;
  }

  const bool background = !(zbest < kBig);
  const bool inside = px < w && py < h;
  const size_t row0 = static_cast<size_t>(r) * h;
  if (inside) bg[(row0 + py) * w + px] = background ? 1 : 0;

  if ((w & 3) != 0) {  // image rows are not 16-byte aligned: scalar stores
    if (inside) {
      float* out = img + ((row0 + py) * w + px) * 3;
      out[0] = background ? 0.f : cr;
      out[1] = background ? 0.f : cg;
      out[2] = background ? 0.f : cb;
    }
    return;
  }
  // A tile row is 48 contiguous floats = 12 vectors; w % 4 == 0 and tx0 % 16 == 0
  // keep every vector aligned and the ragged right edge on a vector boundary.
  const int vec_row = tid / 12, vec = tid % 12;
  const bool store = tid < kTile * 12 && ty0 + vec_row < h &&
                     vec * 4 < min(kTile, w - tx0) * 3;
  float4* dst = reinterpret_cast<float4*>(
      img + ((row0 + ty0 + vec_row) * w + tx0) * 3 + vec * 4);
  if (tri_hits == 0) {  // an empty tile (the same for every thread): no barrier
    if (store) *dst = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  __syncthreads();  // every warp is done with s_coef
  s_coef[tid * 3 + 0] = background ? 0.f : cr;
  s_coef[tid * 3 + 1] = background ? 0.f : cg;
  s_coef[tid * 3 + 2] = background ? 0.f : cb;
  __syncthreads();
  if (store) *dst = reinterpret_cast<const float4*>(s_coef)[tid];
}

struct Geometry {
  int t_pad, n_groups, n_tiles_x, n_tiles_y;
};

Geometry geometry(int n_tris, int h, int w) {
  Geometry g;
  g.n_groups = (n_tris + kGroup - 1) / kGroup;
  g.t_pad = g.n_groups * kGroup;
  g.n_tiles_x = (w + kTile - 1) / kTile;
  g.n_tiles_y = (h + kTile - 1) / kTile;
  return g;
}

template <typename Loader>
int launch(Loader loader, float* table, float* gbbox, float* img, unsigned char* bg,
           int* tile_counts, int n_renders, int n_tris, int h, int w, int phases,
           cudaStream_t stream) {
  if (n_renders <= 0 || h <= 0 || w <= 0) return 0;
  const Geometry g = geometry(n_tris, h, w);
  if ((phases & 1) && g.t_pad > 0) {
    dim3 grid((g.t_pad + kThreads - 1) / kThreads, n_renders);
    raster_setup_kernel<<<grid, kThreads, 0, stream>>>(
        loader, table, reinterpret_cast<float4*>(gbbox), n_tris, g.t_pad);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (phases & 2) {
    dim3 grid(g.n_tiles_x * g.n_tiles_y, n_renders);
    raster_tiles_kernel<<<grid, kThreads, 0, stream>>>(
        table, reinterpret_cast<const float4*>(gbbox), img, bg, tile_counts, g.t_pad,
        g.n_groups, h, w, g.n_tiles_x);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

extern "C" int fusg_raster_corners(const float* screen, const float* colors,
                                   const unsigned char* cull, float* table,
                                   float* gbbox, float* img, unsigned char* bg,
                                   int* tile_counts, int n_renders, int n_tris, int h,
                                   int w, int phases, cudaStream_t stream) {
  return launch(CornerLoader{screen, colors, cull, n_tris}, table, gbbox, img, bg,
                tile_counts, n_renders, n_tris, h, w, phases, stream);
}

extern "C" int fusg_raster_indexed(const float* verts, const float* vert_colors,
                                   const void* tris, int tris_int64, int tris_batched,
                                   int n_verts, float* table, float* gbbox, float* img,
                                   unsigned char* bg, int* tile_counts, int n_renders,
                                   int n_tris, int h, int w, int phases,
                                   cudaStream_t stream) {
  if (tris_int64)
    return launch(IndexedLoader<long long>{verts, vert_colors,
                                           static_cast<const long long*>(tris), n_verts,
                                           n_tris, tris_batched},
                  table, gbbox, img, bg, tile_counts, n_renders, n_tris, h, w, phases,
                  stream);
  return launch(IndexedLoader<int>{verts, vert_colors, static_cast<const int*>(tris),
                                   n_verts, n_tris, tris_batched},
                table, gbbox, img, bg, tile_counts, n_renders, n_tris, h, w, phases,
                stream);
}

extern "C" int fusg_raster_plan(int n_tris, int h, int w, int* out) {
  const Geometry g = geometry(n_tris, h, w);
  cudaFuncAttributes attr;
  const int rc = static_cast<int>(cudaFuncGetAttributes(&attr, raster_tiles_kernel));
  out[0] = g.t_pad;
  out[1] = g.n_groups;
  out[2] = (g.t_pad + kThreads - 1) / kThreads;
  out[3] = g.n_tiles_x * g.n_tiles_y;
  out[4] = kThreads;
  out[5] = (g.n_groups + kPassGroups - 1) / kPassGroups;
  out[6] = rc == 0 ? static_cast<int>(attr.sharedSizeBytes) : -1;
  return rc;
}
