// N1: greedy non-maximum suppression over boxes in score order, every segment of a
// call in one launch.
//
// Not a port of a TPU kernel: the JAX package runs NMS as a lax.scan over the boxes
// (ops/detection.py:45-88 nms_static, no Pallas). A step of that scan is a handful of
// tiny operations, so on the card it would be ~1,000 launches an NMS call.
//
// A call holds up to kNmsMaxSegments independent segments (the five FPN levels of the
// RPN, or one); each segment's boxes stand in the order the greedy pass visits them
// (descending score: the callers hand them sorted). One thread-block cluster of kCluster
// blocks a segment, every block with the segment's boxes and areas in its shared memory:
//
// 1. The overlap bitmask. Word (i, t) of row i holds bit k when box i overlaps box
//    j = 64 t + k, j > i, by IoU > threshold; the words are stored column-major (word
//    (i, t) at t n + i), so that a tile's rows of one word lie together and the scan
//    reads them at constant offsets. The cluster's warps share items of 32 rows x 32
//    columns of the upper triangle round robin, with no barrier between items: a lane
//    holds a column's box, four rows are decided at a time, and a warp ballot a row
//    gives the row's 32 bits (rows 32-63 x columns 0-31 of a diagonal tile are never
//    read, and skipped). The decision is the plain version's (ops/detection.py
//    batched_iou, round-to-nearest intrinsics, no contracted multiply-add), with the
//    IEEE division taken only where an approximate quotient lies within 2^-18 of the
//    threshold: the same bits, at a fraction of the divisions. Up to kNmsSmemBoxes
//    boxes (the wrapper's NMS_SMEM_BOXES) the mask, n * ceil(n / 64) words <= 128 KB,
//    goes straight into the shared memory of the cluster's rank 0 through distributed
//    shared memory, so the scan reads it locally and the mask never crosses device
//    memory; a longer segment (up to kNmsMaxBoxes) writes it to a global scratch, in
//    L2 at these sizes.
// 2. After a cluster barrier (release / acquire), one warp of rank 0 scans 64-row
//    tiles. Lane 0 resolves a tile's own 64 x 64 diagonal block in registers: 64
//    dependent steps of a test and a predicated OR, the rows' words loaded 16 at a time
//    ahead of use. The warp then writes the kept rows' indices and ORs their words past
//    the tile into the "removed" words (a lane a word, 16 loads in flight), skips tiles
//    whose rows are all removed, and stops once max_out boxes are kept. (Handing the
//    ORs to the block's other warps through shared-memory flags measured slower: the
//    fences cost more than the ORs.) A box whose score is not above score_thr starts
//    out removed: it is never kept and suppresses nothing, so it may stand anywhere in
//    the order.
//
// Bound: the mask is n^2 / 2 IoUs (about 12 operations each) and n^2 / 8 bytes; at n =
// 1,000 that is below a microsecond of the card's work. What is left is latency: the
// launch, two cluster barriers and the scan, sequential by nature (a box's fate
// depends on every box before it).

#include "fusg_kernels.h"

#include <cooperative_groups.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kNmsMaxSegments = 16;  // segments a call (detection.py NMS_MAX_SEGMENTS)
constexpr int kNmsMaxBoxes = 4096;   // boxes a segment: 64 removed words, two a lane
constexpr int kNmsSmemBoxes = 1024;  // a longer segment's mask goes to the scratch
constexpr int kCluster = 16;  // blocks a segment (8 measured slower at 1,000 boxes)
constexpr int kTile = 64;
constexpr int kThreads = 384;  // 12 warps: room for the scan's 64 words in flight unspilled
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = kNmsMaxBoxes / kTile;
using u64 = unsigned long long;

struct Segments {
  int start[kNmsMaxSegments];       // first box
  int len[kNmsMaxSegments];         // boxes
  int out_start[kNmsMaxSegments];   // first output slot
  int max_out[kNmsMaxSegments];     // output slots
  long long scratch[kNmsMaxSegments];  // the mask's first word in the scratch; -1: shared
};

__device__ __forceinline__ float area_rn(float4 a) {
  return __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f), fmaxf(__fsub_rn(a.w, a.y), 0.f));
}

// The IoU's numerator and denominator as the plain version computes them
// (ops/detection.py batched_iou): intersection and max(union, 1e-9).
__device__ __forceinline__ void iou_parts(float4 a, float area_a, float4 b, float area_b,
                                          float& inter, float& uni) {
  const float ix0 = fmaxf(a.x, b.x), iy0 = fmaxf(a.y, b.y);
  const float ix1 = fminf(a.z, b.z), iy1 = fminf(a.w, b.w);
  inter = __fmul_rn(fmaxf(__fsub_rn(ix1, ix0), 0.f), fmaxf(__fsub_rn(iy1, iy0), 0.f));
  uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
}

// The kept rows of one 64-row tile, by one thread. rem has a bit set for every row
// already removed or invalid; diag[r] is row r's word of its own tile (bits k > r
// only). 64 dependent steps, each a test and a predicated OR; the words come 16 rows at
// a time, the next 16 in flight while these are resolved, and rows 32..63 only as
// their high halves.
__device__ __forceinline__ u64 resolve_tile(const u64* diag, int rows, u64 rem) {
  const unsigned* half = reinterpret_cast<const unsigned*>(diag);
  unsigned lo = static_cast<unsigned>(rem), hi = static_cast<unsigned>(rem >> 32);
  u64 d[16], nd[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) d[r] = r < rows ? diag[r] : 0ull;
#pragma unroll
  for (int r = 0; r < 16; ++r) nd[r] = r + 16 < rows ? diag[r + 16] : 0ull;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (!(lo & (1u << r))) {
      lo |= static_cast<unsigned>(d[r]);
      hi |= static_cast<unsigned>(d[r] >> 32);
    }
  }
  unsigned h0[16], h1[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) h0[r] = r + 32 < rows ? half[2 * (r + 32) + 1] : 0u;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (!(lo & (1u << (r + 16)))) {
      lo |= static_cast<unsigned>(nd[r]);
      hi |= static_cast<unsigned>(nd[r] >> 32);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) h1[r] = r + 48 < rows ? half[2 * (r + 48) + 1] : 0u;
#pragma unroll
  for (int r = 0; r < 16; ++r)
    if (!(hi & (1u << r))) hi |= h0[r];
#pragma unroll
  for (int r = 0; r < 16; ++r)
    if (!(hi & (1u << (r + 16)))) hi |= h1[r];
  // Row r's bit changes only in steps before r, so a row is kept exactly when its bit
  // is still clear at the end.
  return ~(static_cast<u64>(hi) << 32 | lo);
}

// OR of the words col[r] over the rows r of a tile kept (keep's bits): 64 loads, 16 in
// flight, each masked by its row's bit.
__device__ __forceinline__ u64 or_kept(const u64* col, int rows, u64 keep) {
  u64 acc = 0ull;
#pragma unroll
  for (int b = 0; b < kTile; b += 16) {
    const unsigned kb = static_cast<unsigned>(keep >> b) & 0xffffu;
    u64 w[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) w[r] = b + r < rows ? col[b + r] : 0ull;
#pragma unroll
    for (int r = 0; r < 16; ++r) acc |= (kb >> r) & 1u ? w[r] : 0ull;
  }
  return acc;
}

// The greedy pass over one segment's mask (column-major: word (i, j) at mask[j n + i]),
// by one warp: lane j holds removed words j and j + 32.
__device__ __forceinline__ void scan(const u64* mask, const u64* s_valid, int n, int tiles,
                                     int max_out, long long* o) {
  const int lane = threadIdx.x & 31;
  u64 removed0 = 0ull, removed1 = 0ull;
  int kept = 0;
  for (int t = 0; t < tiles && kept < max_out; ++t) {
    const u64 rem =
        __shfl_sync(0xffffffffu, t < 32 ? removed0 : removed1, t & 31) | ~s_valid[t];
    if (rem == ~0ull) continue;  // every row removed: nothing kept, nothing to OR
    const int rows = min(kTile, n - t * kTile);
    const u64* tile_rows = mask + t * kTile;  // word j of the tile's rows: tile_rows + j n
    u64 keep = 0ull;
    if (lane == 0) keep = resolve_tile(tile_rows + static_cast<long long>(t) * n, rows, rem);
    keep = __shfl_sync(0xffffffffu, keep, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if ((keep >> r) & 1ull) {
        const int pos = kept + __popcll(keep & ((1ull << r) - 1ull));
        const int i = t * kTile + r;
        if (pos < max_out) o[pos] = i;
      }
    }
    kept += __popcll(keep);
    if (kept >= max_out) break;
    if (lane > t && lane < tiles)
      removed0 |= or_kept(tile_rows + static_cast<long long>(lane) * n, rows, keep);
    if (lane + 32 > t && lane + 32 < tiles)
      removed1 |= or_kept(tile_rows + static_cast<long long>(lane + 32) * n, rows, keep);
  }
  for (int s = min(kept, max_out) + lane; s < max_out; s += 32) o[s] = -1;
}

// Dynamic shared memory of every block: the segment's boxes and their areas; rank 0's
// also holds a shared-memory segment's mask, n x tiles words, in front of them.
__global__ void __launch_bounds__(kThreads, 1)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, Segments segs,
           float iou_thr, float score_thr, u64* __restrict__ scratch,
           long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ u64 s_valid[kMaxTiles];  // rank 0's: bit r of tile t = box 64 t + r scores
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int seg = blockIdx.x / csize;
  const int n = segs.len[seg], tiles = (n + kTile - 1) / kTile;
  const bool in_smem = segs.scratch[seg] < 0;
  u64* s_mask = reinterpret_cast<u64*>(smem);
  const size_t mask_bytes =
      in_smem ? (static_cast<size_t>(n) * tiles * sizeof(u64) + 15) / 16 * 16 : 0;
  float4* s_box = reinterpret_cast<float4*>(smem + mask_bytes);
  float* s_area = reinterpret_cast<float*>(s_box + n);
  u64* mask = in_smem ? cluster.map_shared_rank(s_mask, 0) : scratch + segs.scratch[seg];
  const float4* b = boxes + segs.start[seg];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float4 bi = b[i];
    s_box[i] = bi;
    s_area[i] = area_rn(bi);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (rank == 0) {  // which rows' scores pass, a word a tile
    const float* sc = scores + segs.start[seg];
    for (int t = warp; t < tiles; t += kWarps) {
      const int i0 = t * kTile + lane, i1 = i0 + 32;
      const unsigned v0 = __ballot_sync(0xffffffffu, i0 < n && sc[i0] > score_thr);
      const unsigned v1 = __ballot_sync(0xffffffffu, i1 < n && sc[i1] > score_thr);
      if (lane == 0) s_valid[t] = v0 | static_cast<u64>(v1) << 32;
    }
  }
  const float band = fmaxf(fabsf(iou_thr) * 0x1p-18f, 0x1p-120f);
  const float lo = iou_thr - band, hi = iou_thr + band;
  cluster.sync();  // the boxes are in, and every block of the cluster runs

  // 1. The mask: items of 32 rows x 32 columns of a (row tile, column tile >= row tile)
  // pair round robin over the cluster's warps. A lane holds one column's box; four rows
  // are decided at a time, then four warp ballots give their 32 bits each, and lane r
  // keeps row r's word. The mask is column-major: word (i, j) at mask[j n + i].
  const int items = tiles * (tiles + 1) * 2;
  for (int item = rank * kWarps + warp; item < items; item += csize * kWarps) {
    int rt = 0, rest = item >> 2;
    while (rest >= tiles - rt) rest -= tiles - rt++;
    const int ct = rt + rest, rh = (item >> 1) & 1, chalf = item & 1;
    if (rt == ct && rh > chalf) continue;  // below the diagonal: never read
    const int r0 = rt * kTile + 32 * rh, j = ct * kTile + 32 * chalf + lane;
    const int nrows = min(32, n - r0);
    const bool col = j < n;
    const float4 bj = col ? s_box[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float area_j = col ? s_area[j] : 0.f;
    unsigned word = 0u;
    for (int r = 0; r < nrows; r += 4) {
      // IoU > thr as the plain version decides it (inter / uni rounded to nearest, then
      // compared): the approximate quotient (__fdividef, within 2^-21) decides outside a
      // band of 2^-18 |thr| (at least 2^-120) around thr; inside it, where rounding
      // could matter, the IEEE division does. A NaN decides false both ways.
      bool hit[4], open = false;
      float inter[4], uni[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = min(r0 + r + u, n - 1);
        iou_parts(s_box[i], s_area[i], bj, area_j, inter[u], uni[u]);
        const float q = __fdividef(inter[u], uni[u]);
        const bool live = col && j > r0 + r + u && r + u < nrows;
        hit[u] = live && q > hi;
        const bool near = live && q >= lo && q <= hi;
        open |= near;
        inter[u] = near ? inter[u] : -1.f;  // -1 marks a decided row
      }
      if (open) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (inter[u] >= 0.f) hit[u] = __fdiv_rn(inter[u], uni[u]) > iou_thr;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned bits = __ballot_sync(0xffffffffu, hit[u]);
        if (lane == r + u) word = bits;
      }
    }
    if (lane < nrows)
      reinterpret_cast<unsigned*>(mask + static_cast<long long>(ct) * n + r0 + lane)[chalf] = word;
  }
  if (!in_smem) __threadfence();
  cluster.sync();  // the mask is complete and visible to rank 0
  if (rank != 0 || warp != 0) return;

  // 2. The scan.
  long long* o = out + segs.out_start[seg];
  if (in_smem)
    scan(s_mask, s_valid, n, tiles, segs.max_out[seg], o);
  else
    scan(mask, s_valid, n, tiles, segs.max_out[seg], o);
}

}  // namespace

// Dynamic shared memory of a segment's blocks: its mask (n x ceil(n / 64) words, 16-byte
// aligned) when it is kept there, and the boxes with their areas.
static int segment_smem(int n, bool mask_in_smem) {
  const int mask = n * ((n + kTile - 1) / kTile) * static_cast<int>(sizeof(u64));
  return (mask_in_smem ? (mask + 15) / 16 * 16 : 0) + n * (16 + 4);
}

extern "C" int fusg_nms_segments(const float* boxes, const float* scores, int n_segments,
                                 const int* seg_start, const int* seg_len,
                                 const int* out_start, const int* max_out,
                                 const long long* scratch_start, float iou_thr, float score_thr,
                                 unsigned long long* scratch, long long* out,
                                 cudaStream_t stream) {
  if (n_segments < 1 || n_segments > kNmsMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  Segments segs{};
  int smem = 0;
  for (int s = 0; s < n_segments; ++s) {
    const int n = seg_len[s];
    if (n < 0 || n > kNmsMaxBoxes || max_out[s] < 0 ||
        (scratch_start[s] < 0 && n > kNmsSmemBoxes))
      return static_cast<int>(cudaErrorInvalidValue);
    segs.start[s] = seg_start[s];
    segs.len[s] = n;
    segs.out_start[s] = out_start[s];
    segs.max_out[s] = max_out[s];
    segs.scratch[s] = scratch_start[s];
    smem = std::max(smem, segment_smem(n, scratch_start[s] < 0));
  }
  // The kernel's attributes, once a device (setting them again is harmless).
  static bool attributes_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !attributes_set[dev]) {
    err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        std::max(segment_smem(kNmsSmemBoxes, true), segment_smem(kNmsMaxBoxes, false)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attributes_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kCluster * n_segments));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_kernel, reinterpret_cast<const float4*>(boxes), scores,
                           segs, iou_thr, score_thr, scratch, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
