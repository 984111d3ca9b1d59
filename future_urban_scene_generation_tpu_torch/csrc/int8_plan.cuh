// The int8 tier's launch plan, shared by N3 (quant_int8.cu), which writes the weight
// codes as an image of N2's shared-memory tiles, and N2 (conv_int8.cu), which copies
// that image into shared memory as it is. ops/cuda_conv.py int8_plan mirrors it.
//
// Both operands of N2's wgmma are K-major tiles in the 128-byte swizzle (the layout
// a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes): a row of a tile is 128 codes
// (one K-block of a pixel, or of an output channel), 8 rows make a 1,024-byte atom,
// and the 16-byte chunk j of row r sits at chunk j ^ (r % 8) of its row. A chunk is
// 16 channels of one tap, k ordered (ky, kx, c) with C padded to a multiple of 16.
//
// A transposed conv (stride s) runs as s * s stride-1 convs of the undilated input,
// one per output phase (py, px): phase py uses the taps ky = ky0 + s t of the
// flipped kernel, ky0 = (lo - py) mod s (lo = k - 1 - p), so every phase walks
// taps = ceil(k / s) taps an axis; taps past k hold zero codes.
#pragma once

namespace fusg_int8 {

constexpr int kBM = 128;     // output pixels a tile: two consumer warpgroups of 64 rows
constexpr int kBK = 128;     // codes a K-block: one swizzled 128-byte row a pixel
constexpr int kStages = 4;   // K-blocks in flight in the shared-memory ring
constexpr int kAlign = 1024; // a swizzle atom; tiles start on one

struct Int8Plan {
  int bn;       // output channels a tile: 64, 128 above 64 outputs, 256 above 128
  int bk;       // kBK
  int stages;   // kStages
  int smem;     // bytes of dynamic shared memory N2 asks for
  int phases;   // s * s for a transposed conv of stride s, else 1
  int taps;     // taps an axis the kernel walks: k, or ceil(k / s) a phase
  int cp;       // channels padded to a multiple of 16
  int k_img;    // taps^2 * cp rounded up to kBK
  int o_tiles;  // output-channel tiles
};

__host__ __device__ inline int int8_round_up(int x, int m) { return (x + m - 1) / m * m; }

inline Int8Plan int8_plan(int c, int k, int cout, int phase_s) {
  Int8Plan p;
  p.bn = cout > 128 ? 256 : cout > 64 ? 128 : 64;
  p.bk = kBK;
  p.stages = kStages;
  p.smem = kStages * (kBM + p.bn) * kBK + kAlign + 2 * kStages * 8;
  p.phases = phase_s * phase_s;
  p.taps = (k + phase_s - 1) / phase_s;
  p.cp = int8_round_up(c, 16);
  p.k_img = int8_round_up(p.taps * p.taps * p.cp, kBK);
  p.o_tiles = (cout + p.bn - 1) / p.bn;
  return p;
}

// Byte offset of code (row r, k) inside one swizzled tile of 128-code rows.
__host__ __device__ inline int swizzled(int r, int k) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((((k >> 4) ^ r) & 7) << 4) + (k & 15);
}

// The first tap of phase q (0 <= q < s) of a transposed conv with low padding lo,
// and the phase's own low padding on the undilated input.
__host__ __device__ inline int phase_tap0(int lo, int q, int s) { return ((lo - q) % s + s) % s; }
__host__ __device__ inline int phase_pad(int lo, int q, int s) {
  return -((q + phase_tap0(lo, q, s) - lo) / s);
}

}  // namespace fusg_int8
