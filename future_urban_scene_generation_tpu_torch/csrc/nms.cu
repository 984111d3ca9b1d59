// N1: greedy non-maximum suppression over score-sorted boxes, in two launches.
//
// Not a port of a TPU kernel: the JAX package runs NMS as a lax.scan over the boxes
// (ops/detection.py:45-88 nms_static, no Pallas). A step of that scan is a handful of
// tiny operations, so on the card it would be ~1,000 launches an NMS call and six
// calls a Mask R-CNN frame. Here:
//
// 1. nms_mask_kernel: one block of 64 threads per (row tile, column tile) of 64 boxes;
//    thread i of a row tile writes one 64-bit word whose bit k says that box i
//    overlaps box j = 64 * column tile + k, j > i, by IoU > threshold. The IoU is the
//    plain version's arithmetic (ops/detection.py batched_iou) with round-to-nearest
//    intrinsics, so no multiply-add is contracted and every comparison matches it.
// 2. nms_scan_kernel: one warp walks the boxes in score order. It copies a tile of 64
//    mask rows (and scores) into shared memory at a time, then for each row decides
//    from the "removed" bit words kept in shared memory, and ORs a kept row into them
//    (lanes own words). It stops when max_out boxes are kept and writes the kept
//    boxes' original indices, -1 after them.
//
// Bound: the mask is n^2 IoUs (about 12 operations each) and n^2 / 8 bytes; at n =
// 1,000 that is microseconds of work, and both launches are latency-bound: the scan
// is sequential by nature (a box's fate depends on every box before it).

#include "fusg_kernels.h"

namespace {

constexpr int kTile = 64;

__device__ __forceinline__ float iou_rn(float4 a, float4 b) {
  const float ix0 = fmaxf(a.x, b.x), iy0 = fmaxf(a.y, b.y);
  const float ix1 = fminf(a.z, b.z), iy1 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix1, ix0), 0.f), fmaxf(__fsub_rn(iy1, iy0), 0.f));
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f), fmaxf(__fsub_rn(a.w, a.y), 0.f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n, float thr,
                                unsigned long long* __restrict__ mask, int col_blocks) {
  const int row_tile = blockIdx.y, col_tile = blockIdx.x;
  if (row_tile > col_tile) return;  // only j > i matters; the scan reads no such word
  const int row_size = min(n - row_tile * kTile, kTile);
  const int col_size = min(n - col_tile * kTile, kTile);
  __shared__ float4 cols[kTile];
  if (threadIdx.x < col_size) cols[threadIdx.x] = boxes[col_tile * kTile + threadIdx.x];
  __syncthreads();
  if (threadIdx.x >= row_size) return;
  const int i = row_tile * kTile + threadIdx.x;
  const float4 a = boxes[i];
  unsigned long long bits = 0;
  for (int k = (row_tile == col_tile) ? threadIdx.x + 1 : 0; k < col_size; ++k) {
    if (iou_rn(a, cols[k]) > thr) bits |= 1ULL << k;
  }
  mask[static_cast<long long>(i) * col_blocks + col_tile] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const float* __restrict__ scores,
                                const long long* __restrict__ order, int n, int col_blocks,
                                float score_thr, int max_out, long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;                 // [col_blocks]
  unsigned long long* tile = smem + col_blocks;       // [kTile][col_blocks]
  float* tile_scores = reinterpret_cast<float*>(tile + kTile * col_blocks);  // [kTile]
  const int lane = threadIdx.x;
  for (int j = lane; j < col_blocks; j += 32) removed[j] = 0;
  int kept = 0;
  for (int b = 0; b < col_blocks && kept < max_out; ++b) {
    const int rows = min(kTile, n - b * kTile);
    const int width = col_blocks - b;
    __syncwarp();
    for (int t = lane; t < rows * width; t += 32) {
      const int r = t / width, j = b + t % width;
      tile[r * col_blocks + j] = mask[static_cast<long long>(b * kTile + r) * col_blocks + j];
    }
    for (int r = lane; r < rows; r += 32) tile_scores[r] = scores[b * kTile + r];
    __syncwarp();
    for (int r = 0; r < rows; ++r) {
      const bool keep = !((removed[b] >> r) & 1ULL) && tile_scores[r] > score_thr;
      if (!keep) continue;
      if (lane == 0) out[kept] = order[b * kTile + r];
      if (++kept >= max_out) break;
      for (int j = b + lane; j < col_blocks; j += 32) removed[j] |= tile[r * col_blocks + j];
      __syncwarp();
    }
  }
  for (int t = kept + lane; t < max_out; t += 32) out[t] = -1;
}

}  // namespace

extern "C" int fusg_nms_smem_bytes(int n) {
  const int col_blocks = (n + kTile - 1) / kTile;
  return col_blocks * 8 * (kTile + 1) + kTile * 4;
}

extern "C" int fusg_nms(const float* boxes_sorted, const float* scores_sorted,
                        const long long* order, int n, float iou_thr, float score_thr,
                        int max_out, unsigned long long* mask, long long* out,
                        cudaStream_t stream) {
  const int col_blocks = (n + kTile - 1) / kTile;
  dim3 grid(col_blocks, col_blocks);
  nms_mask_kernel<<<grid, kTile, 0, stream>>>(reinterpret_cast<const float4*>(boxes_sorted),
                                              n, iou_thr, mask, col_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<1, 32, fusg_nms_smem_bytes(n), stream>>>(
      mask, scores_sorted, order, n, col_blocks, score_thr, max_out, out);
  return static_cast<int>(cudaGetLastError());
}
