// N2: the int8 serving tier's convolution on int8 codes, exact int32 accumulation,
// per-output-channel dequantization: out[m][o] = float32(acc[m][o]) * sw[o], written
// as float32 or bfloat16 NHWC.
//
// Not a port of a TPU kernel: the JAX package computes this product in XLA, as an
// int8 lax.conv_general_dilated with an int32 accumulator (models/layers.py:206-214
// _int8_conv, :233-241 _int8_conv_transpose). The quantization itself (scales,
// round half to even, clamp to +-127) stays torch ops in models/layers.py, as it is
// XLA ops outside any kernel there; PyTorch has no int8 convolution on CUDA.
//
// One kernel, two entries:
//   fusg_conv_int8            conv with stride, zero padding and kernel dilation;
//   fusg_conv_transpose_int8  the transposed conv as JAX lowers it: the input dilated
//                             by the stride (holes of zeros), the kernel already
//                             flipped by the caller, padding lo = k-1-p, hi = lo + op.
// Both map output pixel (oy, ox) and tap (ky, kx) to the virtual input row
// vy = oy * stride + ky * dil - pad_lo, which is a real input row iy = vy / ld when
// vy >= 0, vy % ld == 0 and iy < H (ld = input dilation, 1 for the plain conv).
//
// Implicit GEMM: M = N*Ho*Wo output pixels, N_gemm = C_out, K = kh*kw*C (C a
// multiple of 16: the wrapper pads the channels with zero codes otherwise), k
// ordered (ky, kx, c). Weights arrive packed as (C_out, Kp) int8, Kp = K rounded up
// to 32 with zero codes.
//   * A block owns 128 pixels x 64 output channels; 8 warps of 32 x 32, each a 2 x 4
//     grid of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 tiles (exact int32).
//   * The K loop steps 32 codes at a time through a 3-stage cp.async ring. The A tile
//     is a masked gather: each 16-byte copy is 16 channels of one input pixel at one
//     tap, or, with a source size of 0, sixteen zeros for zero padding, a hole of the
//     input dilation, a pixel past M or k past K. Rows are padded to 48 bytes so the
//     fragment loads (4 bytes a lane, 8 rows x 4 lanes) hit 32 distinct banks.
//   * Epilogue: __int2float_rn (an int32 above 2^24 rounds to nearest even, as the
//     CPU's conversion) times sw[o] with __fmul_rn, then float32 or, rounded to
//     nearest even, bfloat16.
//
// Bound on an H100: 2*M*C_out*K operations on the int8 tensor cores (1,979 TOP/s
// dense) against the bytes of the codes in and the output out; the ICN's trunk convs
// are bound by operations. This first version keeps mma.sync and cp.async; wgmma, TMA
// and skipping the input-dilation holes (the transposed convs multiply 4x their
// useful taps) are later work.

#include "fusg_kernels.h"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 32, kStages = 3;
constexpr int kRow = 48;  // bytes of one smem row: 32 codes + 16 bytes of pad
constexpr int kThreads = 256;

struct Int8Geom {
  int n, h, w, c;         // input codes (n, h, w, c), c % 16 == 0
  int kh, kw, cout;       // taps and output channels
  int ho, wo;             // output size
  int stride, dil, ld;    // output stride, kernel dilation, input dilation
  int pad_y, pad_x;       // low padding
  int k_real, kp;         // kh * kw * c and its round-up to 32
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(float* out, long long idx, float v) { out[idx] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* out, long long idx, float v) {
  out[idx] = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wpk,
                 const float* __restrict__ sw, OutT* __restrict__ out, Int8Geom g) {
  __shared__ __align__(16) int8_t smem_a[kStages][kBM * kRow];
  __shared__ __align__(16) int8_t smem_b[kStages][kBN * kRow];

  const int tid = threadIdx.x;
  const long long m_total = static_cast<long long>(g.n) * g.ho * g.wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int o0 = blockIdx.y * kBN;

  // The A copy of this thread: one 16-code half (chunk) of one pixel row.
  const int a_row = tid >> 1, a_chunk = tid & 1;
  const long long m = m0 + a_row;
  const bool m_ok = m < m_total;
  int img = 0, vy0 = 0, vx0 = 0;
  if (m_ok) {
    const int ox = static_cast<int>(m % g.wo);
    const long long t = m / g.wo;
    const int oy = static_cast<int>(t % g.ho);
    img = static_cast<int>(t / g.ho);
    vy0 = oy * g.stride - g.pad_y;
    vx0 = ox * g.stride - g.pad_x;
  }
  // The B copy: threads 0..127, one 16-code half of one output channel's row.
  const int b_row = (tid & 127) >> 1, b_chunk = tid & 1;
  const bool b_thread = tid < 2 * kBN;
  const bool b_ok = b_thread && (o0 + b_row) < g.cout;
  const int8_t* b_src = wpk + static_cast<long long>(b_ok ? o0 + b_row : 0) * g.kp + b_chunk * 16;

  const int n_steps = g.kp / kBK;

  auto load_stage = [&](int stage, int step) {
    const int k = step * kBK + a_chunk * 16;
    bool ok = m_ok && k < g.k_real;
    const int8_t* src = x;
    if (ok) {
      const int tap = k / g.c, ci = k - tap * g.c;
      const int ky = tap / g.kw, kx = tap - ky * g.kw;
      const int vy = vy0 + ky * g.dil, vx = vx0 + kx * g.dil;
      const int iy = vy / g.ld, ix = vx / g.ld;
      ok = vy >= 0 && vx >= 0 && iy * g.ld == vy && ix * g.ld == vx && iy < g.h && ix < g.w;
      if (ok) src = x + ((static_cast<long long>(img) * g.h + iy) * g.w + ix) * g.c + ci;
    }
    cp_async16(&smem_a[stage][a_row * kRow + a_chunk * 16], src, ok);
    if (b_thread) {
      cp_async16(&smem_b[stage][b_row * kRow + b_chunk * 16],
                 b_ok ? b_src + step * kBK : wpk, b_ok);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 1, warp_n = warp & 1;  // 4 x 2 warps of 32 x 32
  const int grp = lane >> 2, tig = lane & 3;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < n_steps) load_stage(next % kStages, next);
    cp_async_commit();

    const int8_t* as = smem_a[step % kStages];
    const int8_t* bs = smem_b[step % kStages];
    unsigned af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp_m * 32 + i * 16 + grp;
      af[i][0] = *reinterpret_cast<const unsigned*>(as + r * kRow + tig * 4);
      af[i][1] = *reinterpret_cast<const unsigned*>(as + (r + 8) * kRow + tig * 4);
      af[i][2] = *reinterpret_cast<const unsigned*>(as + r * kRow + 16 + tig * 4);
      af[i][3] = *reinterpret_cast<const unsigned*>(as + (r + 8) * kRow + 16 + tig * 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = warp_n * 32 + j * 8 + grp;
      bf[j][0] = *reinterpret_cast<const unsigned*>(bs + c * kRow + tig * 4);
      bf[j][1] = *reinterpret_cast<const unsigned*>(bs + c * kRow + 16 + tig * 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // Epilogue: c0, c1 at (row grp, cols 2 tig, 2 tig + 1), c2, c3 eight rows lower.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + warp_n * 32 + j * 8 + tig * 2;
    const float s0 = o < g.cout ? sw[o] : 0.f;
    const float s1 = o + 1 < g.cout ? sw[o + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + warp_m * 32 + i * 16 + grp + half * 8;
        if (row >= m_total) continue;
        const long long base = row * g.cout;
        if (o < g.cout)
          store_out(out, base + o, __fmul_rn(__int2float_rn(acc[i][j][2 * half]), s0));
        if (o + 1 < g.cout)
          store_out(out, base + o + 1, __fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), s1));
      }
    }
  }
}

int launch(const void* x, const void* wpk, const float* sw, void* out, int out_dtype,
           const Int8Geom& g, cudaStream_t stream) {
  const long long m_total = static_cast<long long>(g.n) * g.ho * g.wo;
  if (g.c % 16 != 0 || g.kp % kBK != 0 || g.kp < g.k_real || m_total <= 0 || g.cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid_x = (m_total + kBM - 1) / kBM;
  const int grid_y = (g.cout + kBN - 1) / kBN;
  if (grid_x > 2147483647LL || grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(grid_x), grid_y);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(wpk);
  if (out_dtype == 0) {
    conv_int8_kernel<float><<<grid, kThreads, 0, stream>>>(xi, wi, sw, static_cast<float*>(out), g);
  } else {
    conv_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        xi, wi, sw, static_cast<__nv_bfloat16*>(out), g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fusg_conv_int8(const void* x, const void* wpk, const float* sw, void* out,
                              int out_dtype, int n, int h, int w, int c, int kh, int kw,
                              int cout, int ho, int wo, int stride, int pad_y, int pad_x,
                              int dil, int kp, cudaStream_t stream) {
  const Int8Geom g{n, h, w, c, kh, kw, cout, ho, wo, stride, dil, 1, pad_y, pad_x,
                   kh * kw * c, kp};
  return launch(x, wpk, sw, out, out_dtype, g, stream);
}

extern "C" int fusg_conv_transpose_int8(const void* x, const void* wpk, const float* sw,
                                        void* out, int out_dtype, int n, int h, int w, int c,
                                        int kh, int kw, int cout, int ho, int wo,
                                        int in_dilation, int pad_y, int pad_x, int kp,
                                        cudaStream_t stream) {
  const Int8Geom g{n, h, w, c, kh, kw, cout, ho, wo, 1, 1, in_dilation, pad_y, pad_x,
                   kh * kw * c, kp};
  return launch(x, wpk, sw, out, out_dtype, g, stream);
}
