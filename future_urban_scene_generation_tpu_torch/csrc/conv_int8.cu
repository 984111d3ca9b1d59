// N2: the int8 serving tier's convolution on int8 codes, exact int32 accumulation,
// per-output-channel dequantization: out[m][o] = float32(acc[m][o]) * sw[o], written
// as float32 or bfloat16 NHWC.
//
// Not a port of a TPU kernel: the JAX package computes this product in XLA, as an
// int8 lax.conv_general_dilated with an int32 accumulator (models/layers.py:206-214
// _int8_conv, :233-241 _int8_conv_transpose). Its operands come from N3
// (quant_int8.cu), which quantizes the activation and the weight in one launch and
// writes the weight codes as an image of this kernel's shared-memory tiles.
//
// What bounds it on an H100: an implicit GEMM of M = N*Ho*Wo output pixels, N_gemm =
// C_out and K = kh*kw*C: 2*M*C_out*K operations on the int8 tensor cores (1,979
// TOP/s dense) against the codes in and the output out once. The ICN trunk conv (N=24,
// 64^2, 256 -> 256, 3x3) does 1.16e11 operations over ~75 MB: bound by operations,
// 0.0586 ms. The first version (mma.sync.m16n8k32, 128 px x 64 channels a block,
// 4-byte fragment loads) ran at 9% of that: per 32-deep step a warp issued 12
// shared-memory loads for 8 small products, and a 256-channel output gathered each
// input pixel four times.
//
// This design: the product is wgmma.mma_async.m64nNk32.s32.s8.s8 with both operands
// read from shared memory through descriptors, N = 256 output channels a tile above
// 128 outputs (128 above 64, else 64: int8_plan.cuh), so the trunk's 256 outputs
// gather each input pixel once a tap, not four times. A block of three warpgroups is
// persistent (one per SM) and walks tiles of 128 pixels x N channels, output-channel
// tiles of one pixel tile next to each other so the second finds the pixels in L2; at
// N = 256 the consumers hold 128 accumulators a thread and take the producers'
// registers (setmaxnreg):
//   * Producer warpgroup. The A operand is an implicit-GEMM gather and cannot be a
//     tiled TMA load (padding, strides and dilation break the box): each thread keeps
//     eight pixels' coordinates and copies one 16-byte chunk (16 channels of one tap)
//     of each with cp.async, source size 0 (zeros) for padding, pixels past M and k
//     past K, straight to its swizzled address: 8 neighbouring threads read a pixel's
//     128 contiguous bytes and write 8 distinct bank groups. The B operand needs no
//     addressing: N3 wrote the weight codes as the swizzled shared-memory image of each
//     (phase, output tile, K-block), so one thread moves it with one cp.async.bulk onto
//     the stage's mbarrier. A ring of 4 stages of 128 codes; a thread arrives on a
//     stage's full barrier two stages later, after its copies landed
//     (cp.async.wait_group) and a proxy fence (wgmma reads through the async proxy).
//   * Two consumer warpgroups, 64 pixels each: per stage four wgmma k32 behind one
//     fence and one commit (no branch in between: ptxas would fence every product,
//     C7519), wait_group 1, then release the stage before on its empty barrier.
//   * Transposed convs skip the holes of the input dilation: a stride-s transposed
//     conv is s^2 stride-1 convs of the undilated input, one per output phase, each
//     with its taps of the flipped kernel (int8_plan.cuh); phases are tiles of their
//     own, written at their interleaved output pixels. The sums are the same integers,
//     so this is bit-equal to the dilated form, with a quarter of its products for
//     EdgeConnect's 4x4 stride-2 convs.
//   * Epilogue from the accumulators: __int2float_rn (an int32 above 2^24 rounds to
//     nearest even, as the CPU's conversion) times sw[o] with __fmul_rn, then float32
//     (8-byte pairs, 32 contiguous bytes a quad) or RNE bfloat16; full bf16 tiles go
//     out as 16-byte stores after two butterfly shuffles inside each quad, as
//     conv_core.cuh's epilogue does.
// What holds it now: the A gather. Every input pixel crosses L2 once a tap (9 times for
// a 3x3 conv) through 16-byte cp.async; more stages, a longer producer lag, L1-cached
// copies and mbarrier-tracked copies measured the same. A staged input patch read as
// shifted windows (the sliding view of conv_core.cuh; wgmma's no-swizzle layout can
// start a tile at any pixel) would cut that traffic about 4x for 3x3 stride-1 convs.

#include "conv_core.cuh"
#include "fusg_kernels.h"
#include "int8_plan.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using fusg_conv::smem_u32;
using fusg_conv::wgmma_desc;
using namespace fusg_int8;

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kLag = 2;        // stages a producer thread's copies fly before it arrives
constexpr int kMaxPhases = 16;
// Registers a thread after setmaxnreg at N = 256: 128 x 56 + 256 x 224 <= 65,536.
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kLag <= kStages - 2, "a producer arrives kLag stages late; consumers release a "
              "stage one stage late: beyond kStages - 2 they wait on each other");

struct Int8Geom {
  int n, h, w, cp;                 // input codes (n, h, w, cp), cp % 16 == 0
  int cout, ho, wo;                // output (n, ho, wo, cout)
  int taps;                        // taps an axis the kernel walks (a phase's)
  int stride, dil, pad_y, pad_x;   // the conv (phase_s == 1)
  int phase_s, lo_y, lo_x;         // the transposed conv: stride s, low padding k-1-p
  int n_kb, o_tiles;               // K-blocks, output-channel tiles
};

struct Phase {
  int qy, qx, hq, wq, pad_y, pad_x, stride, dil, step;
  int mq;  // output pixels of the phase
};

__device__ __forceinline__ Phase phase_of(const Int8Geom& g, int q) {
  Phase p;
  if (g.phase_s == 1) {
    p.qy = p.qx = 0;
    p.hq = g.ho;
    p.wq = g.wo;
    p.pad_y = g.pad_y;
    p.pad_x = g.pad_x;
    p.stride = g.stride;
    p.dil = g.dil;
    p.step = 1;
  } else {
    const int s = g.phase_s;
    p.qy = q / s;
    p.qx = q % s;
    p.hq = g.ho > p.qy ? (g.ho - p.qy + s - 1) / s : 0;
    p.wq = g.wo > p.qx ? (g.wo - p.qx + s - 1) / s : 0;
    p.pad_y = phase_pad(g.lo_y, p.qy, s);
    p.pad_x = phase_pad(g.lo_x, p.qx, s);
    p.stride = p.dil = 1;
    p.step = s;
  }
  p.mq = g.n * p.hq * p.wq;
  return p;
}

// Tile t -> (phase, first pixel, first output channel); output tiles of one pixel tile
// are neighbours.
__device__ __forceinline__ void tile_of(const Int8Geom& g, int t, Phase& ph, int& q, int& m0,
                                        int& o_tile) {
  o_tile = t % g.o_tiles;
  int mt = t / g.o_tiles;
  const int n_phases = g.phase_s * g.phase_s;
  for (q = 0; q < n_phases; ++q) {
    ph = phase_of(g, q);
    const int tiles = (ph.mq + kBM - 1) / kBM;
    if (mt < tiles) break;
    mt -= tiles;
  }
  m0 = mt * kBM;
}

// ------------------------------------------------------------- primitives ----
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// A wait that outlasts ~2^34 cycles (9 s) can only be a lost arrival: trap, so that
// the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, int bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A K-major tile in the 128-byte swizzle: 1,024 bytes from one 8-row atom to the
// next, the leading offset unused; layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr) {
  return wgmma_desc(smem_addr, 0, 1024) | (1ull << 62);
}

// d (this thread's part of the 64 x 64 int32 tile) += A (64 x 32 codes behind desc_a) *
// B (64 x 32 codes behind desc_b)^T, both K-major in the 128-byte swizzle.
__device__ __forceinline__ void wgmma_s8(int (&d)[8][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (this thread's part of the 64 x 128 int32 tile) += A (64 x 32 codes behind desc_a) *
// B (128 x 32 codes behind desc_b)^T, both K-major in the 128-byte swizzle.
__device__ __forceinline__ void wgmma_s8(int (&d)[16][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (this thread's part of the 64 x 256 int32 tile) += A (64 x 32 codes behind desc_a) *
// B (256 x 32 codes behind desc_b)^T, both K-major in the 128-byte swizzle.
__device__ __forceinline__ void wgmma_s8(int (&d)[32][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]),
        "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]),
        "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]),
        "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),
        "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]),
        "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]),
        "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]),
        "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]),
        "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3]),
        "+r"(d[24][0]), "+r"(d[24][1]), "+r"(d[24][2]), "+r"(d[24][3]),
        "+r"(d[25][0]), "+r"(d[25][1]), "+r"(d[25][2]), "+r"(d[25][3]),
        "+r"(d[26][0]), "+r"(d[26][1]), "+r"(d[26][2]), "+r"(d[26][3]),
        "+r"(d[27][0]), "+r"(d[27][1]), "+r"(d[27][2]), "+r"(d[27][3]),
        "+r"(d[28][0]), "+r"(d[28][1]), "+r"(d[28][2]), "+r"(d[28][3]),
        "+r"(d[29][0]), "+r"(d[29][1]), "+r"(d[29][2]), "+r"(d[29][3]),
        "+r"(d[30][0]), "+r"(d[30][1]), "+r"(d[30][2]), "+r"(d[30][3]),
        "+r"(d[31][0]), "+r"(d[31][1]), "+r"(d[31][2]), "+r"(d[31][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float dequant(int acc, float s) {
  return __fmul_rn(__int2float_rn(acc), s);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stores the two output rows of this thread (pixel offsets row_off[half] into out, in
// elements, or -1 past M) of a 64 x BN accumulator tile at channels o0 ..
template <int BN, typename OutT>
__device__ __forceinline__ void store_rows(const int (&acc)[BN / 8][4],
                                           const long long (&row_off)[2], OutT* __restrict__ out,
                                           const float* __restrict__ sw, int o0, int cout,
                                           int lane) {
  const int tq = lane & 3;
  if constexpr (sizeof(OutT) == 2) {
    if ((cout & 7) == 0 && o0 + BN <= cout) {
      // Full tiles: per 64-channel group two butterfly exchanges inside each quad turn
      // the fragments' column pairs into 16 contiguous channels a lane (one pixel's 64
      // channels leave as 128 contiguous bytes).
      const bool hi = (tq & 2) != 0, lo = (tq & 1) != 0;
#pragma unroll
      for (int grp = 0; grp < BN / 64; ++grp) {
        float s[8][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int o = o0 + 64 * grp + 8 * nt + 2 * tq;
          s[nt][0] = sw[o];
          s[nt][1] = sw[o + 1];
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t w[8];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            w[nt] = bf16x2_bits(dequant(acc[8 * grp + nt][2 * half], s[nt][0]),
                                dequant(acc[8 * grp + nt][2 * half + 1], s[nt][1]));
          }
          uint32_t y[2][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t keep = hi ? w[4 + i] : w[i];
            const uint32_t recv = __shfl_xor_sync(0xffffffffu, hi ? w[i] : w[4 + i], 2);
            y[0][i] = hi ? recv : keep;
            y[1][i] = hi ? keep : recv;
          }
          uint32_t z[2][2][2];
#pragma unroll
          for (int sb = 0; sb < 2; ++sb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t keep = lo ? y[sb][2 + e] : y[sb][e];
              const uint32_t recv =
                  __shfl_xor_sync(0xffffffffu, lo ? y[sb][e] : y[sb][2 + e], 1);
              z[sb][0][e] = lo ? recv : keep;
              z[sb][1][e] = lo ? keep : recv;
            }
          if (row_off[half] >= 0) {
            uint4* dst = reinterpret_cast<uint4*>(out + row_off[half] + o0 + 64 * grp + 16 * tq);
            dst[0] = make_uint4(z[0][0][0], z[0][1][0], z[1][0][0], z[1][1][0]);
            dst[1] = make_uint4(z[0][0][1], z[0][1][1], z[1][0][1], z[1][1][1]);
          }
        }
      }
      return;
    }
  }
  const bool pairs = (cout & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int o = o0 + 8 * nt + 2 * tq;
    const float s0 = o < cout ? sw[o] : 0.f;
    const float s1 = o + 1 < cout ? sw[o + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (row_off[half] < 0 || o >= cout) continue;
      const float v0 = dequant(acc[nt][2 * half], s0);
      const float v1 = dequant(acc[nt][2 * half + 1], s1);
      OutT* dst = out + row_off[half] + o;
      if constexpr (sizeof(OutT) == 4) {
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (o + 1 < cout) dst[1] = v1;
        }
      } else {
        if (pairs) {
          *reinterpret_cast<uint32_t*>(dst) = bf16x2_bits(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (o + 1 < cout) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
conv_int8_wgmma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wimg,
                       const float* __restrict__ sw, OutT* __restrict__ out, Int8Geom g,
                       int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kABytes = kBM * kBK, kBBytes = BN * kBK;
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t a_ring = base, b_ring = base + kStages * kABytes;
  const uint32_t full = b_ring + kStages * kBBytes, empty = full + kStages * 8;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128 + 1);  // 128 producer threads + the bulk copy's arrive
      mbar_init(empty + 8 * s, 256);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------------------------------------------------------- producer
    if constexpr (BN == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int p = tid - 256;
    const int chunk = p & 7;  // this thread's 16-code chunk of every 128-code row
    // Pixel rows (p >> 3) + 16 i keep their row in the atom: 2,048 bytes apart.
    const uint32_t a_off = swizzled(p >> 3, chunk * 16);
    int seq = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      Phase ph;
      int q, m0, o_tile;
      tile_of(g, t, ph, q, m0, o_tile);
      int vy0[8], vx0[8], pix0[8];  // pix0: the image's first pixel, -1 past M
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (p >> 3) + 16 * i;
        pix0[i] = -1;
        vy0[i] = vx0[i] = 0;
        if (m < ph.mq) {
          const int b = m % ph.wq, rest = m / ph.wq;
          const int a = rest % ph.hq, img = rest / ph.hq;
          pix0[i] = img * g.h * g.w;
          vy0[i] = a * ph.stride - ph.pad_y;
          vx0[i] = b * ph.stride - ph.pad_x;
        }
      }
      // Tap (ty, tx) and channel ci of this thread's chunk in the current K-block.
      int ci = chunk * 16, ty = 0, tx = 0;
      while (ci >= g.cp) {
        ci -= g.cp;
        if (++tx == g.taps) tx = 0, ++ty;
      }
      const int8_t* b_src = wimg + static_cast<size_t>(q * g.o_tiles + o_tile) * g.n_kb * kBBytes;
      for (int kb = 0; kb < g.n_kb; ++kb, ++seq) {
        const int s = seq % kStages;
        mbar_wait(empty + 8 * s, ((seq / kStages) & 1) ^ 1);
        if (p == 0) {
          mbar_arrive_expect_tx(full + 8 * s, kBBytes);
          bulk_copy_g2s(b_ring + s * kBBytes, b_src + static_cast<size_t>(kb) * kBBytes, kBBytes,
                        full + 8 * s);
        }
        const bool in_k = ty < g.taps;
        const int dy = ty * ph.dil, dx = tx * ph.dil;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int vy = vy0[i] + dy, vx = vx0[i] + dx;
          const bool ok = in_k && pix0[i] >= 0 && static_cast<unsigned>(vy) < static_cast<unsigned>(g.h) &&
                          static_cast<unsigned>(vx) < static_cast<unsigned>(g.w);
          const int8_t* src =
              ok ? x + (static_cast<long long>(pix0[i] + vy * g.w + vx) * g.cp + ci) : x;
          cp_async16(a_ring + s * kABytes + a_off + 2048 * i, src, ok);
        }
        cp_async_commit();
        if (seq >= kLag) {
          cp_async_wait<kLag>();
          fence_proxy_async();
          mbar_arrive(full + 8 * ((seq - kLag) % kStages));
        }
        ci += kBK;
        while (ci >= g.cp) {
          ci -= g.cp;
          if (++tx == g.taps) tx = 0, ++ty;
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int r = seq - kLag < 0 ? 0 : seq - kLag; r < seq; ++r) mbar_arrive(full + 8 * (r % kStages));
    return;
  }

  // ------------------------------------------------------------------ consumers
  // 128 accumulators a thread at N = 256: the consumers take the producers' registers.
  if constexpr (BN == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, lane = tid & 31, warp = (tid & 127) >> 5;
  int seq = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    Phase ph;
    int q, m0, o_tile;
    tile_of(g, t, ph, q, m0, o_tile);
    int acc[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int kb = 0; kb < g.n_kb; ++kb, ++seq) {
      const int s = seq % kStages;
      mbar_wait(full + 8 * s, (seq / kStages) & 1);
      const uint64_t da = sw128_desc(a_ring + s * kABytes + wg * 64 * kBK);
      const uint64_t db = sw128_desc(b_ring + s * kBBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 32; ++ks) wgmma_s8(acc, da + 2 * ks, db + 2 * ks);  // +32 B
      wgmma_commit();
      wgmma_wait<1>();
      if (kb > 0) mbar_arrive(empty + 8 * ((seq - 1) % kStages));
    }
    wgmma_wait<0>();
    mbar_arrive(empty + 8 * ((seq - 1) % kStages));

    long long row_off[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * half;
      row_off[half] = -1;
      if (m < ph.mq) {
        const int b = m % ph.wq, rest = m / ph.wq;
        const int a = rest % ph.hq, img = rest / ph.hq;
        const int oy = ph.qy + ph.step * a, ox = ph.qx + ph.step * b;
        row_off[half] = ((static_cast<long long>(img) * g.ho + oy) * g.wo + ox) * g.cout;
      }
    }
    store_rows<BN, OutT>(acc, row_off, out, sw, o_tile * BN, g.cout, lane);
  }
}

template <int BN, typename OutT>
int launch_typed(const int8_t* x, const int8_t* wimg, const float* sw, void* out,
                 const Int8Geom& g, int n_tiles, int smem, cudaStream_t stream) {
  auto kernel = conv_int8_wgmma_kernel<BN, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_tiles < sms ? n_tiles : sms;
  kernel<<<grid, kThreads, smem, stream>>>(x, wimg, sw, static_cast<OutT*>(out), g, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* wimg, const float* sw, void* out, int out_dtype,
           Int8Geom g, int c, int k, cudaStream_t stream) {
  const Int8Plan plan = int8_plan(c, k, g.cout, g.phase_s);
  if (g.cp != plan.cp || g.n <= 0 || g.cout <= 0 || g.ho <= 0 || g.wo <= 0 ||
      g.phase_s < 1 || g.phase_s * g.phase_s > kMaxPhases ||
      (g.phase_s > 1 && (g.stride != 1 || g.dil != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  g.taps = plan.taps;
  g.n_kb = plan.k_img / kBK;
  g.o_tiles = plan.o_tiles;
  long long m_tiles = 0;
  for (int q = 0; q < plan.phases; ++q) {
    const int s = g.phase_s;
    const long long hq = g.phase_s == 1 ? g.ho : (g.ho > q / s ? (g.ho - q / s + s - 1) / s : 0);
    const long long wq = g.phase_s == 1 ? g.wo : (g.wo > q % s ? (g.wo - q % s + s - 1) / s : 0);
    m_tiles += (g.n * hq * wq + kBM - 1) / kBM;
  }
  const long long n_tiles = m_tiles * g.o_tiles;
  if (n_tiles <= 0 || n_tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(wimg);
  const int nt = static_cast<int>(n_tiles);
  if (plan.bn == 256) {
    return out_dtype == 0 ? launch_typed<256, float>(xi, wi, sw, out, g, nt, plan.smem, stream)
                          : launch_typed<256, __nv_bfloat16>(xi, wi, sw, out, g, nt, plan.smem,
                                                             stream);
  }
  if (plan.bn == 128) {
    return out_dtype == 0 ? launch_typed<128, float>(xi, wi, sw, out, g, nt, plan.smem, stream)
                          : launch_typed<128, __nv_bfloat16>(xi, wi, sw, out, g, nt, plan.smem,
                                                             stream);
  }
  return out_dtype == 0 ? launch_typed<64, float>(xi, wi, sw, out, g, nt, plan.smem, stream)
                        : launch_typed<64, __nv_bfloat16>(xi, wi, sw, out, g, nt, plan.smem,
                                                          stream);
}

}  // namespace

extern "C" int fusg_conv_int8(const void* x, const void* wimg, const float* sw, void* out,
                              int out_dtype, int n, int h, int w, int c, int k, int cout,
                              int ho, int wo, int stride, int pad_y, int pad_x, int dil,
                              cudaStream_t stream) {
  const Int8Geom g{n, h, w, fusg_int8::int8_round_up(c, 16), cout, ho, wo, 0, stride, dil,
                   pad_y, pad_x, 1, 0, 0, 0, 0};
  return launch(x, wimg, sw, out, out_dtype, g, c, k, stream);
}

extern "C" int fusg_conv_transpose_int8(const void* x, const void* wimg, const float* sw,
                                        void* out, int out_dtype, int n, int h, int w, int c,
                                        int k, int cout, int ho, int wo, int stride, int lo_y,
                                        int lo_x, cudaStream_t stream) {
  const Int8Geom g{n, h, w, fusg_int8::int8_round_up(c, 16), cout, ho, wo, 0, 1, 1, 0, 0,
                   stride, lo_y, lo_x, 0, 0};
  return launch(x, wimg, sw, out, out_dtype, g, c, k, stream);
}

extern "C" int fusg_int8_plan(int c, int k, int cout, int phase_s, int* out) {
  const fusg_int8::Int8Plan p = fusg_int8::int8_plan(c, k, cout, phase_s);
  const int v[9] = {p.bn, p.bk, p.stages, p.smem, p.phases, p.taps, p.cp, p.k_img, p.o_tiles};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}
