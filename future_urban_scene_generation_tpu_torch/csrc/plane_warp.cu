// W1: the scene's plane warp (render/plane_warp.py warp_planes_plain, behind
// stages.warp_planes_to_crop) past its homographies and slot rules, in one launch at the
// crop's grid and two at a reduced one: the sample, the polygon test, the paste and the
// composite of every element of the (N, 5, 256, 256, 3) output.
//
// Not a port of a TPU kernel: the JAX package warps the planes in XLA (no Pallas). The
// plain version runs as eager torch, about 1,300-1,700 host-enqueued operations a call,
// over a thousand of them past the homographies (the 4-tap gathers, the 6-edge polygon
// test, the paste's weight matrices and einsums, the composite), while the card's work is
// bound by the output write (94 MB at N = 24: 28 us at 3.35 TB/s). So the design is one
// pass over the output.
//
// The homographies stay the plain version's (geometry/homography.py through torch: an f32
// eigh, Cholesky and LU), handed in as their inverses: a plane a few pixels wide, which
// random-weight perception makes of a far vehicle, has a homography near singular, whose
// inverse a rounding moves by percents (a float64 solve here read 1-2.5% off the plain
// f32 one, and the scene judge failed on it), so only the same operations give the same
// sample.
//
// Design:
//   - the plan, in torch beside the homographies: each warp's source plane, slot and
//     whether it writes (render/plane_warp.py _warps, the plain warp's own rules).
//   - grid kernel (res < 256 only), a block per (row n, warp k): thread 0 reads the warp's
//     plan and its box (the destination polygon's, padded by a pixel); the block samples
//     the r^2 grid over the box into scratch, value minus black, and notes each channel
//     that holds a non-finite value.
//   - compose kernel, a block per (row n, crop row y), a thread per crop column: at res
//     256 it samples each of the 3 warps at the crop pixel; at a reduced res it pastes
//     each writing warp's grid with the antialiased linear kernel of ops/crop.py
//     scale_and_translate (the grid's columns weighted by the row's y weights once for
//     the block, into shared memory, then each column's x weights). Then the plain
//     version's composite, out = out * (1 - write) + tex * write over the 3 warps in order
//     and all 5 slots, so that a non-finite texel spreads as it does there, and the 5
//     output rows leave through shared memory as 16-byte stores.
//
// Arithmetic: every elementwise step of the projective map, the source-table
// coordinates, the bilinear blend, the polygon crossing, the grid, the paste weights and
// the composite is the plain version's eager operation on the card, one rounding each
// (__f*_rn, never contracted), including ATen's division by a Python scalar as a product
// with its reciprocal; the weights' totals take ATen's reduction order and the paste's
// einsums cuBLAS's ascending FMA chains (both read off the card), so W1 equals the plain
// version bit for bit.

#include "fusg_kernels.h"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kOut = 256;  // crop side (stages.SKETCH_RES): a thread a crop column
constexpr int kPlanes = 5;
constexpr int kWarps = 3;  // the side warp, front/back, the remaining plane
constexpr int kPts = 6;  // polygon points (4-gons padded to 6)
constexpr int kMaxRes = 256;
constexpr int kGridThreads = 256;

// One warp of one row, as both kernels read it.
struct WarpParams {
  float hi[9];  // the inverse homography, destination frame -> source frame
  float bx0, by0, bw, bh;  // the destination polygon's box, padded by a pixel
  float poly[2 * kPts];  // the source polygon
  int slot, ok;  // ok: valid homography and not skipped
  int nonfinite;  // bit c: channel c of the reduced grid holds a non-finite value
};

__device__ __forceinline__ float f_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float f_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float f_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float f_div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
// amin / amax: NaN wins.
__device__ __forceinline__ float nan_min(float m, float v) {
  return (v < m || isnan(v)) && !isnan(m) ? v : m;
}
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || isnan(v)) && !isnan(m) ? v : m;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ long long table_row(const FusgPlaneWarpArgs& a, int n) {
  const long long i = a.table_index[n];
  return i < 0 ? 0 : (i >= a.n_tables ? a.n_tables - 1 : i);
}

// Warp k of row n as the plain warp picks it (render/plane_warp.py _warps): the source
// polygon, the slot, ok, the inverse homography and the destination box.
__device__ void warp_params(const FusgPlaneWarpArgs& a, int n, int k, WarpParams& P) {
  const long long w = static_cast<long long>(k) * a.n + n;
  for (int i = 0; i < 9; ++i) P.hi[i] = a.hi_t[w * 9 + (i % 3) * 3 + i / 3];
  const int s_idx = static_cast<int>(a.src_plane[w]), d_idx = static_cast<int>(a.slot[w]);
  P.slot = d_idx;
  P.ok = a.ok[w];
  P.nonfinite = 0;
  const float* sp = a.src_polys + (n * kPlanes + s_idx) * 2 * kPts;
  const float* dp = a.dst_polys + (n * kPlanes + d_idx) * 2 * kPts;
  for (int i = 0; i < 2 * kPts; ++i) P.poly[i] = sp[i];
  float x0 = dp[0], x1 = dp[0], y0 = dp[1], y1 = dp[1];
  for (int i = 1; i < kPts; ++i) {
    x0 = nan_min(x0, dp[2 * i]);
    x1 = nan_max(x1, dp[2 * i]);
    y0 = nan_min(y0, dp[2 * i + 1]);
    y1 = nan_max(y1, dp[2 * i + 1]);
  }
  P.bx0 = f_sub(x0, 1.0f);
  P.by0 = f_sub(y0, 1.0f);
  P.bw = clamp_min(f_sub(f_add(x1, 1.0f), P.bx0), static_cast<float>(1e-3));
  P.bh = clamp_min(f_sub(f_add(y1, 1.0f), P.by0), static_cast<float>(1e-3));
}

// ---------------------------------------------------------------------------
// The sample: projective map, source-table coordinates, polygon test, bilinear read.

struct Source {  // a row's source table and window, as the sample reads them
  const void* table;
  float x0, y0, tsx, tsy;  // window origin; table / window side (reciprocal x table)
};

__device__ __forceinline__ Source source_of(const FusgPlaneWarpArgs& a, int n) {
  const long long t = table_row(a, n);
  const float res = static_cast<float>(a.table_res);
  Source s;
  s.x0 = a.src_win[t];
  s.y0 = a.src_win[a.n_tables + t];
  s.tsx = f_mul(f_div(1.0f, a.src_win[2 * a.n_tables + t]), res);
  s.tsy = f_mul(f_div(1.0f, a.src_win[3 * a.n_tables + t]), res);
  s.table = t * static_cast<long long>(a.table_res) * a.table_res * 3 *
                (a.table_bf16 ? 2 : 4) + static_cast<const char*>(a.table);
  return s;
}

// render/plane_warp.py _inside_poly: even-odd crossings over the 6 edges.
__device__ __forceinline__ bool inside_poly(float px, float py, const float* poly) {
  bool inside = false;
#pragma unroll
  for (int e = 0; e < kPts; ++e) {
    const float x1 = poly[2 * e], y1 = poly[2 * e + 1];
    const float x2 = poly[2 * ((e + 1) % kPts)], y2 = poly[2 * ((e + 1) % kPts) + 1];
    const bool straddle = (y1 > py) != (y2 > py);
    const float denom = y2 == y1 ? 1.0f : f_sub(y2, y1);
    const float xc = f_add(x1, f_div(f_mul(f_sub(py, y1), f_sub(x2, x1)), denom));
    inside = inside != (straddle && px < xc);
  }
  return inside;
}

// where(inside, bilinear(table, t(H^-1 g)), black) at the frame point (gx, gy).
template <typename T>
__device__ __forceinline__ void sample_point(const float* hi, const float* poly,
                                             const Source& src, int res, float gx, float gy,
                                             const float* black, float* out) {
  const float tiny = static_cast<float>(1e-12);
  float den = f_add(f_add(f_mul(hi[6], gx), f_mul(hi[7], gy)), hi[8]);
  den = fabsf(den) < tiny ? tiny : den;
  const float sx = f_div(f_add(f_add(f_mul(hi[0], gx), f_mul(hi[1], gy)), hi[2]), den);
  const float sy = f_div(f_add(f_add(f_mul(hi[3], gx), f_mul(hi[4], gy)), hi[5]), den);
  if (!inside_poly(sx, sy, poly)) {
    out[0] = black[0];
    out[1] = black[1];
    out[2] = black[2];
    return;
  }
  const float tx = f_sub(f_mul(f_add(f_sub(sx, src.x0), 0.5f), src.tsx), 0.5f);
  const float ty = f_sub(f_mul(f_add(f_sub(sy, src.y0), 0.5f), src.tsy), 0.5f);
  // ops/warp.py bilinear_sample: zero outside; non-finite corners read as -2
  const float x0 = floorf(tx), y0 = floorf(ty);
  const float fx = f_sub(tx, x0), fy = f_sub(ty, y0);
  const float last = static_cast<float>(res - 1);
  const bool cx0 = x0 >= 0.0f && x0 <= last, cx1 = x0 >= -1.0f && x0 < last;
  const bool cy0 = y0 >= 0.0f && y0 <= last, cy1 = y0 >= -1.0f && y0 < last;
  const int xi = cx0 || cx1 ? static_cast<int>(x0) : 0;
  const int yi = cy0 || cy1 ? static_cast<int>(y0) : 0;
  const T* tbl = static_cast<const T*>(src.table);
  const float gx0 = f_sub(1.0f, fx), gy0 = f_sub(1.0f, fy);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = cx0 && cy0 ? to_f32(tbl[(yi * res + xi) * 3 + c]) : 0.0f;
    const float v01 = cx1 && cy0 ? to_f32(tbl[(yi * res + xi + 1) * 3 + c]) : 0.0f;
    const float v10 = cx0 && cy1 ? to_f32(tbl[((yi + 1) * res + xi) * 3 + c]) : 0.0f;
    const float v11 = cx1 && cy1 ? to_f32(tbl[((yi + 1) * res + xi + 1) * 3 + c]) : 0.0f;
    const float top = f_add(f_mul(v00, gx0), f_mul(v01, fx));
    const float bot = f_add(f_mul(v10, gx0), f_mul(v11, fx));
    out[c] = f_add(f_mul(top, gy0), f_mul(bot, fy));
  }
}

// One axis of ops/crop.py _weight_mat (antialiased linear kernel, in_size = res) at one
// output coordinate o: the weights over the inputs lo..hi (all others are 0) come from
// weight(i) below, normalised by `total` where `keep`.
struct Axis {
  float sf, ks, total;
  int lo, hi;
  bool keep;
};

__device__ __forceinline__ float raw_weight(const Axis& ax, int i) {
  const float x = f_div(fabsf(f_sub(ax.sf, static_cast<float>(i))), ax.ks);
  return clamp_min(f_sub(1.0f, x), 0.0f);
}

// ATen's sum over dim 1 of the (B, res, 256) weights on the card (read off an H100, torch
// 2.11, at res = 48, 64, 96, 128, 200 and B = 6, 24, 96): Y = 4 block rows (1 below res 64),
// row y summing its elements y, y + Y, ... into 4 accumulators (the unrolled groups of 4,
// then the tail from the first), combined in order; then the rows by a halving tree.
template <int kRows>
__device__ __forceinline__ float aten_dim1_sum(const Axis& ax, int res) {
  float acc[kRows * 4];  // row y's accumulator s at y * 4 + s, in registers
#pragma unroll
  for (int q = 0; q < kRows * 4; ++q) acc[q] = 0.0f;
  for (int e = ax.lo; e <= ax.hi; ++e) {  // the other weights are +0 and change no sum
    const int y = e % kRows, j = e / kRows;
    const int full = (res - y + kRows - 1) / kRows / 4 * 4;  // row y's unrolled groups
    const int slot = y * 4 + (j < full ? j % 4 : j - full);
    const float w = raw_weight(ax, e);
#pragma unroll
    for (int q = 0; q < kRows * 4; ++q)
      if (q == slot) acc[q] = f_add(acc[q], w);
  }
  float part[kRows];
#pragma unroll
  for (int y = 0; y < kRows; ++y)
    part[y] = f_add(f_add(f_add(acc[y * 4], acc[y * 4 + 1]), acc[y * 4 + 2]), acc[y * 4 + 3]);
#pragma unroll
  for (int off = kRows / 2; off > 0; off /= 2)
#pragma unroll
    for (int y = 0; y < off; ++y) part[y] = f_add(part[y], part[y + off]);
  return part[0];
}

__device__ __forceinline__ Axis axis_at(float scale, float translation, int o, int res) {
  Axis ax;
  const float inv = f_div(1.0f, scale);
  ax.ks = clamp_min(inv, 1.0f);
  ax.sf = f_sub(f_sub(f_mul(static_cast<float>(o) + 0.5f, inv), f_mul(translation, inv)), 0.5f);
  ax.lo = 0;
  ax.hi = -1;
  ax.total = 0.0f;
  ax.keep = false;
  const bool inside = ax.sf >= -0.5f && ax.sf <= static_cast<float>(res) - 0.5f;
  if (!inside || !isfinite(ax.ks)) return ax;  // every weight 0 (NaN weights too)
  const float reach = ax.ks + 1.0f;
  const float lo = floorf(ax.sf - reach), hi = ceilf(ax.sf + reach);
  ax.lo = lo <= 0.0f ? 0 : static_cast<int>(lo);
  ax.hi = hi >= static_cast<float>(res - 1) ? res - 1 : static_cast<int>(hi);
  const float total = res >= 64 ? aten_dim1_sum<4>(ax, res) : aten_dim1_sum<1>(ax, res);
  ax.total = total != 0.0f ? total : 1.0f;
  ax.keep = fabsf(total) > static_cast<float>(1000.0 * 1.1920928955078125e-07);
  if (!ax.keep) ax.hi = -1;
  return ax;
}

__device__ __forceinline__ float weight(const Axis& ax, int i) {
  return f_div(raw_weight(ax, i), ax.total);
}

// The paste's scale and translation of one axis (the plain warp's s_res / w, b = -a x0 +
// a/2 - 1/2).
__device__ __forceinline__ void paste_axis(float win_start, float win_side, float box0,
                                           float box_side, float inv_res, float* scale,
                                           float* translation) {
  const float a = f_mul(f_div(1.0f, win_side), static_cast<float>(kOut));
  const float b = f_sub(f_add(f_mul(-a, win_start), f_mul(0.5f, a)), 0.5f);
  *scale = f_mul(f_mul(a, box_side), inv_res);
  *translation = f_add(f_mul(a, box0), b);
}


// ---------------------------------------------------------------------------
// Kernels.

__device__ __forceinline__ int* grid_flags(const FusgPlaneWarpArgs& a) {
  return reinterpret_cast<int*>(a.scratch);
}

__device__ __forceinline__ float* grid_of(const FusgPlaneWarpArgs& a, int n, int k) {
  const long long flags = (static_cast<long long>(a.n) * kWarps + 3) / 4 * 4;
  return a.scratch + flags + (static_cast<long long>(n) * kWarps + k) * a.res * a.res * 3;
}

template <typename T>
__global__ void __launch_bounds__(kGridThreads) plane_warp_grid_kernel(const FusgPlaneWarpArgs a) {
  const int k = blockIdx.x, n = blockIdx.y;
  __shared__ WarpParams P;
  if (threadIdx.x == 0) warp_params(a, n, k, P);
  __syncthreads();
  const Source src = source_of(a, n);
  const int r = a.res;
  const float inv_r = f_div(1.0f, static_cast<float>(r));
  float* out = grid_of(a, n, k);
  bool bad[3] = {false, false, false};
  for (int idx = threadIdx.x; idx < r * r; idx += blockDim.x) {
    const int i = idx / r, j = idx % r;
    const float gx = f_add(P.bx0, f_mul(f_mul(static_cast<float>(j) + 0.5f, inv_r), P.bw));
    const float gy = f_add(P.by0, f_mul(f_mul(static_cast<float>(i) + 0.5f, inv_r), P.bh));
    float v[3];
    sample_point<T>(P.hi, P.poly, src, a.table_res, gx, gy, a.black, v);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rel = f_sub(v[c], a.black[c]);
      out[idx * 3 + c] = rel;
      bad[c] = bad[c] || !isfinite(rel);
    }
  }
  const int nonfinite = (__syncthreads_or(bad[0]) ? 1 : 0) | (__syncthreads_or(bad[1]) ? 2 : 0) |
                        (__syncthreads_or(bad[2]) ? 4 : 0);
  if (threadIdx.x == 0) grid_flags(a)[n * kWarps + k] = nonfinite;
}

template <typename T>
__global__ void __launch_bounds__(kOut) plane_warp_compose_kernel(const FusgPlaneWarpArgs a) {
  const int y = blockIdx.x, n = blockIdx.y, x = threadIdx.x;
  __shared__ WarpParams P[kWarps];
  __shared__ float wy[kWarps][kMaxRes];  // the block's row of each paste's y weights
  __shared__ float tmp[kWarps][kMaxRes * 3];  // the y-weighted grid rows of a paste
  __shared__ __align__(16) float rows[kPlanes][kOut * 3];
  const int r = a.res;
  const bool reduced = r != kOut;
  if (x < kWarps) {
    warp_params(a, n, x, P[x]);
    if (reduced) P[x].nonfinite = grid_flags(a)[n * kWarps + x];
  }
  const float dx0 = a.dst_win[n], dy0 = a.dst_win[a.n + n];
  const float dw = a.dst_win[2 * a.n + n], dh = a.dst_win[3 * a.n + n];
  const float* black = a.black;
  __syncthreads();
  float tex[kWarps][3];
  if (reduced) {
    const float inv_r = f_div(1.0f, static_cast<float>(r));
    // The block's row of each writing warp: tmp[w][c] = sum_h wy(h) grid[h][w][c].
    int lo[kWarps], hi[kWarps];
    for (int k = 0; k < kWarps; ++k) {
      lo[k] = 0;
      hi[k] = -1;
      if (!P[k].ok) continue;
      float sy, ty;
      paste_axis(dy0, dh, P[k].by0, P[k].bh, inv_r, &sy, &ty);
      const Axis ay = axis_at(sy, ty, y, r);
      lo[k] = ay.lo;
      hi[k] = ay.hi;
      if (x >= ay.lo && x <= ay.hi) wy[k][x] = weight(ay, x);
    }
    __syncthreads();
    for (int k = 0; k < kWarps; ++k) {
      const float* g = grid_of(a, n, k);
      for (int i = x; i < r * 3; i += kOut) {  // 0 where the row misses the plane
        float acc = 0.0f;
        for (int h = lo[k]; h <= hi[k]; ++h) acc = __fmaf_rn(g[h * r * 3 + i], wy[k][h], acc);
        tmp[k][i] = acc;
      }
    }
    __syncthreads();
    for (int k = 0; k < kWarps; ++k) {
      // A non-finite texel anywhere in a channel of the grid makes the einsums' whole
      // channel NaN (0 x NaN); a warp that writes no slot adds tex x 0 and no more.
      float acc[3] = {0.0f, 0.0f, 0.0f};
      if (P[k].ok) {
        float sx, tx;
        paste_axis(dx0, dw, P[k].bx0, P[k].bw, inv_r, &sx, &tx);
        const Axis ax = axis_at(sx, tx, x, r);
        for (int w = ax.lo; w <= ax.hi; ++w) {
          const float wt = weight(ax, w);
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[c] = __fmaf_rn(tmp[k][w * 3 + c], wt, acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        tex[k][c] = (P[k].nonfinite >> c) & 1 ? __int_as_float(0x7fffffff) : f_add(acc[c], black[c]);
    }
  } else {
    const Source src = source_of(a, n);
    const float inv_out = 1.0f / kOut;
    const float px = f_sub(f_add(dx0, f_mul(f_mul(static_cast<float>(x) + 0.5f, inv_out), dw)), 0.5f);
    const float py = f_sub(f_add(dy0, f_mul(f_mul(static_cast<float>(y) + 0.5f, inv_out), dh)), 0.5f);
    for (int k = 0; k < kWarps; ++k)
      sample_point<T>(P[k].hi, P[k].poly, src, a.table_res, px, py, black, tex[k]);
  }
  // The composite, as the plain version's out * (1 - write) + tex * write.
  float o[kPlanes][3];
#pragma unroll
  for (int s = 0; s < kPlanes; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) o[s][c] = black[c];
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
#pragma unroll
    for (int s = 0; s < kPlanes; ++s) {
      const float wr = (P[k].ok && P[k].slot == s) ? 1.0f : 0.0f;
      const float keep = f_sub(1.0f, wr);
#pragma unroll
      for (int c = 0; c < 3; ++c) o[s][c] = f_add(f_mul(o[s][c], keep), f_mul(tex[k][c], wr));
    }
  }
#pragma unroll
  for (int s = 0; s < kPlanes; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) rows[s][x * 3 + c] = o[s][c];
  __syncthreads();
  constexpr int kVecs = kOut * 3 / 4;  // float4s a row
  for (int i = x; i < kPlanes * kVecs; i += kOut) {
    const int s = i / kVecs, q = i % kVecs;
    float4* dst = reinterpret_cast<float4*>(
        a.out + ((static_cast<long long>(n) * kPlanes + s) * kOut + y) * kOut * 3);
    dst[q] = reinterpret_cast<const float4*>(rows[s])[q];
  }
}

template <typename T>
int launch(const FusgPlaneWarpArgs& a, int phases, cudaStream_t stream) {
  if (phases & 1) {
    plane_warp_grid_kernel<T><<<dim3(kWarps, a.n), kGridThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & 2) plane_warp_compose_kernel<T><<<dim3(kOut, a.n), kOut, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fusg_plane_warp(const FusgPlaneWarpArgs* args, int phases, cudaStream_t stream) {
  const FusgPlaneWarpArgs& a = *args;
  if (a.n <= 0) return cudaSuccess;
  if (a.res < 1 || a.res > kMaxRes || a.n > 65535 || a.table_res < 1 ||
      ((phases & 1) && a.res == kOut))
    return cudaErrorInvalidValue;
  return a.table_bf16 ? launch<__nv_bfloat16>(a, phases, stream)
                      : launch<float>(a, phases, stream);
}
