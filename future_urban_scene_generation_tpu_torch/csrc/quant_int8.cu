// N3: the int8 serving tier's quantization of one conv's operands, for kernel N2
// (conv_int8.cu). Op for op the JAX package's _int8_conv / _int8_conv_transpose
// quantization (models/layers.py:195-205, :226-232), which XLA fuses around its int8
// convolution; ops/cuda_conv.py quantize_int8_plain is the same function in torch.
//   sx[c] = max(max |x[..., c]| over N, H, W, 1e-12) * float32(1 / 127)
//   w_eff = float32(w) * sx[c];  sw[o] = max(max |w_eff[..., o]|, 1e-12) * float32(1 / 127)
//   x codes = clamp(rint(x / sx), +-127),  w codes = clamp(rint(w_eff / sw), +-127)
// with IEEE division (__fdiv_rn) and round half to even (rintf), so the codes equal
// torch's and JAX's bit for bit (the x codes take a product by the rounded inverse
// where it provably gives the same integer, codes16).
//
// One cooperative launch a call: a persistent grid of at most two blocks an SM (the
// occupancy API's count) and no more blocks than about one item a thread in each phase
// needs, with grid-wide barriers in place of a memset and further launches:
//   (a) every block reduces its share of max |x| a channel: threads read neighbouring
//       channels of a pixel (16 bytes at a time where C allows, eight loads in flight),
//       the pixels walked upwards, the rows of a block merged in shared memory, and the
//       block's maxima written to a scratch of partials (a slice of pixels a row);
//       then the grid takes max |w| over the taps for every (output, input) channel
//       pair, which needs no scale;
//   (b) after the first barrier, a warp a channel reduces its partials into the
//       maxima. The max is taken on the bit pattern of a non-negative float, which
//       orders as the float does (a NaN above infinity), so the result is exact and
//       independent of the order of the blocks. (One atomicMax a channel a block
//       instead serializes ~260 blocks x 256 channels on a few L2 lines: such a max
//       pass read at ~1 TB/s on an H100.) A call of a few pixels has few partials:
//       there every block reduces them itself in (c), and (b) and the second barrier
//       are skipped;
//   (c) after the second, each block takes the scales (and their inverses) into shared
//       memory and writes its contiguous range of the weight image's 16-code chunks: a
//       warp a row the range touches takes sw[o] from the row's maxima over the taps,
//       then the block's threads write the range's codes straight into N2's B operand, the
//       128-byte-swizzled shared-memory image of every (phase, output tile, K-block) of
//       int8_plan.cuh, zero codes for padded channels, taps and output rows (a
//       transposed conv's weight read flipped through negative strides and split into
//       its phase sub-kernels); then every thread writes its share of the x codes (N,
//       H, W, Cp), the channels padded to a multiple of 16 by zero codes, 16 channels a
//       thread and one 16-byte store, 128 bytes of x a thread in flight, the pixels
//       walked downwards: what (a) read last is still in the 50 MB L2.
// What bounds it: bytes. The activation is read twice (the second time partly from
// L2) and its codes written once; the weight is small.

#include "fusg_kernels.h"
#include "int8_plan.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

using namespace fusg_int8;

constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2;  // blocks an SM at most: the max pass's partial slices
constexpr int kInFlight = 8;        // loads a thread of the max pass keeps in flight
constexpr int kMaxChannels = 2048;  // the scales and inverses in shared memory (16 KB)
constexpr int kLocalPartials = 4 * kThreads;  // partials every block reduces itself, at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// |v| as bits that order like the float (the sign cleared).
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

// max(m, 1e-12) * float32(1 / 127), NaN kept as torch's clamp keeps it.
__device__ __forceinline__ float scale_of(unsigned max_bits) {
  const float m = __uint_as_float(max_bits);
  return __fmul_rn(m != m ? m : fmaxf(m, 1e-12f), kInv127);
}

__device__ __forceinline__ int quant(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
}

// 16 x codes: quant(v[e], sc[e]) for channels c0 + e < c, zero past c, packed. With
// inv[e] = 1 / sc[e] rounded (__frcp_rn): here |v / s| <= 127.0001 (s is the channel's
// max over 127) or the quotient is NaN, so q = v * inv is within 2^-15 of the rounded
// quotient v / s; where q's fraction is farther than 2^-12 from one half, no
// half-integer lies between them and rint gives the same integer. Only a chunk with a
// code near a half (or a NaN) takes the IEEE division, for every code of the chunk.
__device__ __forceinline__ uint4 codes16(const float (&v)[16], const float (&sc)[16],
                                         const float (&inv)[16], int c, int c0) {
  float r[16];
  bool near_half = false;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float q = __fmul_rn(v[e], inv[e]);
    near_half |= !(fabsf(q - floorf(q) - 0.5f) > 0x1p-12f);
    r[e] = rintf(q);
  }
  if (near_half) {
#pragma unroll
    for (int e = 0; e < 16; ++e) r[e] = rintf(__fdiv_rn(v[e], sc[e]));
  }
  uint32_t packed[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      const int code = c0 + k < c ? static_cast<int>(fminf(fmaxf(r[k], -127.f), 127.f)) : 0;
      word |= (static_cast<uint32_t>(code) & 0xffu) << (8 * e);
    }
    packed[q] = word;
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// 16 bytes of T as floats: 4 float32 or 8 bfloat16 values.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[N]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      v[2 * i] = __low2float(b), v[2 * i + 1] = __high2float(b);
    }
  }
};

// V values of T from p as floats: one 16-byte load, or one element (V == 1).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(*p);
  } else {
    Vec16<T>::load(p, v);
  }
}

struct WeightView {
  long long s_ky, s_kx, s_c, s_o;  // element strides of the HWIO view (negative: flipped)
  int k, c, cout;
  int phase_s, lo;                 // transposed conv: stride and low padding, else 1, 0
};

// Bits of max |x[p, group * V + e]| over the pixels p of this block's share: a
// thread's row walks pixels p0, p0 + step, ... upwards, kInFlight 16-byte loads at a
// time, the maxima kept on the packed words (|bf16| as 16-bit halves, |f32| as words:
// both order as the floats they encode).
template <typename T, int V>
__device__ __forceinline__ void max_rows(const T* __restrict__ x, long long pixels, int c,
                                         int group, long long p0, long long step,
                                         unsigned (&m)[V]) {
  const T* src = x + static_cast<long long>(group) * V;
  long long p = p0;
  if constexpr (V == 1) {
    for (; p < pixels; p += step) m[0] = max(m[0], abs_bits(to_f32(src[p * c])));
  } else {
    unsigned acc[4] = {0u, 0u, 0u, 0u};
    const auto fold = [&](const uint4& q) {
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (sizeof(T) == 2)
          acc[k] = __vmaxu2(acc[k], w[k] & 0x7fff7fffu);
        else
          acc[k] = max(acc[k], w[k] & 0x7fffffffu);
      }
    };
    for (; p + (kInFlight - 1) * step < pixels; p += kInFlight * step) {
      uint4 q[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        q[u] = *reinterpret_cast<const uint4*>(src + (p + u * step) * c);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) fold(q[u]);
    }
    for (; p < pixels; p += step) fold(*reinterpret_cast<const uint4*>(src + p * c));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 2) {
        m[2 * k] = max(m[2 * k], (acc[k] & 0xffffu) << 16);
        m[2 * k + 1] = max(m[2 * k + 1], acc[k] & 0xffff0000u);
      } else {
        m[k] = max(m[k], acc[k]);
      }
    }
  }
}

// sw[o] of one output row, by one warp (every lane returns it), from the row's maxima
// over the taps (wmax[o][ci], bits of max |w|: scaling by sx[ci] >= 0 and rounding keep
// the order, so max |w_eff| over taps and channels is max over ci of |wmax * sx[ci]|).
__device__ __forceinline__ float weight_scale(int o, int c, const float* __restrict__ s_scale,
                                              const unsigned* __restrict__ wmax) {
  const int lane = threadIdx.x & 31;
  unsigned m = 0u;
  for (int ci = lane; ci < c; ci += 32)
    m = max(m, abs_bits(__fmul_rn(__uint_as_float(__ldcg(wmax + o * c + ci)), s_scale[ci])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return scale_of(m);
}

// One 16-code chunk `ch` of output row o of the weight image (N2's B operand: the
// 128-byte-swizzled shared-memory image of every (phase, output tile, K-block),
// int8_plan.cuh), by one thread; zero codes for padded channels, taps and rows.
template <typename T>
__device__ __forceinline__ void weight_chunk(int o, int ch, const T* __restrict__ wt,
                                             const WeightView& wv, const Int8Plan& plan,
                                             const float* __restrict__ s_scale, float s_o,
                                             int8_t* __restrict__ wimg) {
  const int kchunks = plan.k_img / 16, n_kb = plan.k_img / kBK;
  const int row = o % plan.bn, o_tile = o / plan.bn;
  const bool real = o < wv.cout;
  const int ph = ch / kchunks, kk = (ch % kchunks) * 16;
  const int t = kk / plan.cp, ci0 = kk % plan.cp;
  const int ty = t / plan.taps, tx = t % plan.taps;
  int ky = ty, kx = tx;
  if (wv.phase_s > 1) {
    ky = phase_tap0(wv.lo, ph / wv.phase_s, wv.phase_s) + wv.phase_s * ty;
    kx = phase_tap0(wv.lo, ph % wv.phase_s, wv.phase_s) + wv.phase_s * tx;
  }
  const bool tap_ok = real && ty < plan.taps && ky < wv.k && kx < wv.k;
  uint32_t packed[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = ci0 + 4 * q + e;
      int code = 0;
      if (tap_ok && ci < wv.c) {
        const float w = to_f32(wt[ky * wv.s_ky + kx * wv.s_kx + ci * wv.s_c + o * wv.s_o]);
        code = quant(__fmul_rn(w, s_scale[ci]), s_o);
      }
      word |= (static_cast<uint32_t>(code) & 0xffu) << (8 * e);
    }
    packed[q] = word;
  }
  int8_t* dst = wimg + (static_cast<size_t>(ph * plan.o_tiles + o_tile) * n_kb + kk / kBK) *
                           plan.bn * kBK +
                swizzled(row, kk % kBK);
  *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// 16 channels c0 .. c0 + 15 of pixel p as floats (zeros past c), element by element.
template <typename T>
__device__ __forceinline__ void load16_scalar(const T* __restrict__ x, long long p, int c, int c0,
                                              float (&v)[16]) {
  const T* src = x + p * c + c0;
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = c0 + e < c ? to_f32(src[e]) : 0.f;
}

// 16 channels of one pixel as raw 16-byte words (C a multiple of 16, x 16-byte aligned):
// two words of bfloat16, four of float32, held packed while the load is in flight.
template <typename T>
struct Raw16 {
  static constexpr int kWords = 16 * static_cast<int>(sizeof(T)) / 16;
  uint4 q[kWords];
  __device__ __forceinline__ void load(const T* __restrict__ src) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) q[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  __device__ __forceinline__ void unpack(float (&v)[16]) const {
    constexpr int N = Vec16<T>::N;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      float u[N];
      Vec16<T>::load(reinterpret_cast<const T*>(&q[i]), u);
#pragma unroll
      for (int e = 0; e < N; ++e) v[N * i + e] = u[e];
    }
  }
};


// A chunk of x: pixel p, channels 16 q .. 16 q + 15.
struct Chunk {
  long long p;
  int q;
};

// A thread's walk over the chunks, downwards by `stride` chunks at a time.
struct ChunkWalk {
  long long dp;
  int dq, chunks;
  __device__ __forceinline__ Chunk next(Chunk at) const {
    at.p -= dp;
    at.q -= dq;
    if (at.q < 0) at.q += chunks, --at.p;
    return at;
  }
};

// The scales of channels c0 .. c0 + 15 and their inverses into registers, when they are
// not there already (a thread's q stays fixed when the chunks a pixel divide the
// stride).
__device__ __forceinline__ void scales16(const float* __restrict__ s_scale, int c, int c0,
                                         int& loaded, float (&sc)[16], float (&inv)[16]) {
  if (c0 == loaded) return;
  loaded = c0;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    sc[e] = c0 + e < c ? s_scale[c0 + e] : 1.f;
    inv[e] = c0 + e < c ? s_scale[c + c0 + e] : 1.f;
  }
}

// The whole call, in one cooperative launch. Grid: gx channel blocks x gy pixel slices
// share the max pass (blocks past gx * gy wait), every block the rest.
//   (a) each block's max |x| a channel, written to part[channel][slice] (no atomics:
//       with one atomic a block a channel, 264 blocks on 256 channels held a max
//       pass to ~1 TB/s), then the weight's max |w| over its taps into wmax[o][ci];
//   (b) after a grid barrier, a warp a channel reduces its gy partials into amax;
//   (c) after a second barrier, the scales, the weight rows and the x codes.
// Where the partials are few (c gy <= kLocalPartials: a call of a few pixels), every
// block reduces them itself in (c), and (b) and the second barrier are skipped.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
quant_int8_kernel(const T* __restrict__ x, long long pixels, int c, int ct, int gx, int gy,
                  bool vec16, const T* __restrict__ wt, WeightView wv, Int8Plan plan,
                  unsigned* __restrict__ part, unsigned* __restrict__ wmax,
                  unsigned* __restrict__ amax, int8_t* __restrict__ xq,
                  int8_t* __restrict__ wimg, float* __restrict__ sw) {
  // [2 c + the rows of the weight image a block's range touches]: the scales, their
  // inverses, then the rows' sw.
  extern __shared__ float s_scale[];
  __shared__ unsigned s_rows[kThreads][V];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, blocks = gridDim.x;
  const int slot = static_cast<int>(blockIdx.x);

  // (a)
  const int groups = c / V, rows = kThreads / ct;
  const int gi = tid % ct, row = tid / ct;
  const int group = (slot % gx) * ct + gi;
  const bool sliced = slot < gx * gy;
  unsigned m[V];
#pragma unroll
  for (int e = 0; e < V; ++e) m[e] = 0u;
  if (sliced && row < rows && group < groups)
    max_rows<T, V>(x, pixels, c, group, static_cast<long long>(slot / gx) * rows + row,
                   static_cast<long long>(gy) * rows, m);
#pragma unroll
  for (int e = 0; e < V; ++e) s_rows[tid][e] = m[e];
  __syncthreads();
  if (sliced && tid < ct && group < groups) {
    for (int r = 1; r < rows; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e) m[e] = max(m[e], s_rows[r * ct + tid][e]);
#pragma unroll
    for (int e = 0; e < V; ++e) part[static_cast<long long>(group * V + e) * gy + slot / gx] = m[e];
  }
  // The weight's max |w| over its taps for every (o, ci), which needs no scale.
  const int taps = wv.k * wv.k;
  for (int e = slot * kThreads + tid; e < wv.cout * c; e += blocks * kThreads) {
    const int o = e / c, ci = e % c;
    unsigned mw = 0u;
#pragma unroll 8
    for (int t = 0; t < taps; ++t)
      mw = max(mw, abs_bits(to_f32(wt[(t / wv.k) * wv.s_ky + (t % wv.k) * wv.s_kx + ci * wv.s_c +
                                        o * wv.s_o])));
    wmax[e] = mw;
  }
  grid.sync();
  const bool local = static_cast<long long>(c) * gy <= kLocalPartials;
  if (!local) {
    // (b)
    const int lane = tid & 31;
    for (int ch = slot * kWarps + (tid >> 5); ch < c; ch += blocks * kWarps) {
      const unsigned* src = part + static_cast<long long>(ch) * gy;
      unsigned mc = 0u;
      for (int s = lane; s < gy; s += 32) mc = max(mc, __ldcg(src + s));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = max(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      if (lane == 0) amax[ch] = mc;
    }
    grid.sync();
  }
  // (c)
  unsigned* s_max = reinterpret_cast<unsigned*>(s_scale);  // the maxima, then the scales
  if (local) {
    for (int i = tid; i < c; i += kThreads) s_max[i] = 0u;
    __syncthreads();
    for (int e = tid; e < c * gy; e += kThreads) atomicMax(s_max + e / gy, __ldcg(part + e));
    __syncthreads();
  }
  for (int i = tid; i < c; i += kThreads) {
    const float sx = scale_of(local ? s_max[i] : __ldcg(amax + i));
    s_scale[i] = sx;
    s_scale[c + i] = __frcp_rn(sx);
  }
  __syncthreads();
  // sw and the weight image: the image's 16-code chunks (per_row a row) cut into one
  // contiguous range a block. A warp a row the range touches takes sw (written out by
  // the block holding the row's first chunk), then the block's threads write the
  // range's chunks.
  const int per_row = plan.phases * (plan.k_img / 16);
  const long long w_items = static_cast<long long>(plan.o_tiles) * plan.bn * per_row;
  const long long span = (w_items + blocks - 1) / blocks;
  const long long w_lo = min(w_items, slot * span), w_hi = min(w_items, w_lo + span);
  const int o_first = static_cast<int>(w_lo / per_row);
  const int o_end = w_lo < w_hi ? static_cast<int>((w_hi - 1) / per_row) + 1 : o_first;
  float* s_sw = s_scale + 2 * c;
  for (int o = o_first + (tid >> 5); o < o_end; o += kWarps) {
    const float s_o = o < wv.cout ? weight_scale(o, c, s_scale, wmax) : 1.f;
    if ((tid & 31) == 0) {
      s_sw[o - o_first] = s_o;
      if (o < wv.cout && static_cast<long long>(o) * per_row >= w_lo) sw[o] = s_o;
    }
  }
  __syncthreads();
  for (long long item = w_lo + tid; item < w_hi; item += kThreads) {
    const int o = static_cast<int>(item / per_row);
    weight_chunk<T>(o, static_cast<int>(item % per_row), wt, wv, plan, s_scale,
                    s_sw[o - o_first], wimg);
  }

  // x codes, thread t taking the chunks total - 1 - t, total - 1 - t - stride, ...: the
  // pixels downwards, so that what (a) read last is read first, from L2.
  const int chunks = plan.cp / 16;
  const long long stride = static_cast<long long>(blocks) * kThreads;
  const long long i0 = pixels * chunks - 1 - (static_cast<long long>(slot) * kThreads + tid);
  if (i0 < 0) return;
  const ChunkWalk walk{stride / chunks, static_cast<int>(stride % chunks), chunks};
  int loaded = -1;
  float sc[16], inv[16], v[16];
  if (!vec16) {
    for (Chunk at{i0 / chunks, static_cast<int>(i0 % chunks)}; at.p >= 0; at = walk.next(at)) {
      const int c0 = 16 * at.q;
      load16_scalar<T>(x, at.p, c, c0, v);
      scales16(s_scale, c, c0, loaded, sc, inv);
      *reinterpret_cast<uint4*>(xq + at.p * plan.cp + c0) = codes16(v, sc, inv, c, c0);
    }
    return;
  }
  // A ring of kAhead chunks in flight (128 bytes of x a thread) while one is coded.
  constexpr int kAhead = 128 / (16 * static_cast<int>(sizeof(T)));
  Chunk at[kAhead];
  Raw16<T> raw[kAhead];
  at[0] = Chunk{i0 / chunks, static_cast<int>(i0 % chunks)};
#pragma unroll
  for (int k = 1; k < kAhead; ++k) at[k] = walk.next(at[k - 1]);
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    if (at[k].p >= 0) raw[k].load(x + at[k].p * c + 16 * at[k].q);
  while (true) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (at[k].p < 0) return;  // the walk goes down: every later chunk is past the end
      const int c0 = 16 * at[k].q;
      raw[k].unpack(v);
      scales16(s_scale, c, c0, loaded, sc, inv);
      *reinterpret_cast<uint4*>(xq + at[k].p * plan.cp + c0) = codes16(v, sc, inv, c, c0);
      at[k] = walk.next(at[(k + kAhead - 1) % kAhead]);
      if (at[k].p >= 0) raw[k].load(x + at[k].p * c + 16 * at[k].q);
    }
  }
}

template <typename T, int V>
int launch_grid(const T* x, long long pixels, int c, const T* wt, const WeightView& wv,
                unsigned* part, int part_slices, unsigned* wmax, unsigned* amax, int8_t* xq,
                int8_t* wimg, float* sw, cudaStream_t stream) {
  const Int8Plan plan = int8_plan(c, wv.k, wv.cout, wv.phase_s);
  const int groups = c / V;
  const int ct = std::min(groups, kThreads);
  const int gx = (groups + ct - 1) / ct;
  auto kernel = quant_int8_kernel<T, V>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        2 * sizeof(float) * c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long capacity = static_cast<long long>(std::min(per_sm, kMaxBlocksPerSm)) * sms;
  // Blocks for about one item a thread in every phase, at most the grid that fits: an
  // item is a 16-code chunk of the x codes or of the weight image, or an (output, input)
  // channel pair's max over the taps.
  const long long per_row = plan.phases * (plan.k_img / 16);
  const long long img_rows = static_cast<long long>(plan.o_tiles) * plan.bn;
  const long long chunks = pixels * (plan.cp / 16) + img_rows * per_row;
  const long long work = std::max(chunks, static_cast<long long>(wv.cout) * c);
  long long blocks = std::min((work + kThreads - 1) / kThreads, capacity);
  blocks = std::max<long long>(blocks, gx);
  if (blocks > capacity) return static_cast<int>(cudaErrorInvalidValue);
  // A block's range of weight chunks touches at most span / per_row + 2 rows.
  const long long sw_rows = std::min(img_rows, (img_rows * per_row + blocks - 1) / blocks /
                                                       per_row + 2);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(c) + sw_rows);
  const int rows = kThreads / ct;
  const int gy = static_cast<int>(std::max<long long>(
      1, std::min<long long>({blocks / gx, (pixels + rows - 1) / rows, part_slices})));
  const bool vec16 = c % 16 == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, pixels, c, ct, gx, gy, vec16, wt, wv, plan, part,
                           wmax, amax, xq, wimg, sw);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x_, long long pixels, int c, const void* wt_, const WeightView& wv,
           unsigned* part, int part_slices, unsigned* wmax, unsigned* amax, int8_t* xq,
           int8_t* wimg, float* sw, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* wt = static_cast<const T*>(wt_);
  constexpr int kV = Vec16<T>::N;
  if (c % kV == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0)
    return launch_grid<T, kV>(x, pixels, c, wt, wv, part, part_slices, wmax, amax, xq, wimg, sw,
                              stream);
  return launch_grid<T, 1>(x, pixels, c, wt, wv, part, part_slices, wmax, amax, xq, wimg, sw,
                           stream);
}

}  // namespace

extern "C" int fusg_quant_int8_slices() { return kMaxBlocksPerSm; }

extern "C" int fusg_quant_int8(const void* x, int dtype, int n, int h, int w, int c,
                               const void* wt, long long s_ky, long long s_kx, long long s_c,
                               long long s_o, int k, int cout, int phase_s, int lo,
                               unsigned* part, int part_slices, unsigned* wmax, unsigned* amax,
                               void* xq, void* wimg, float* sw, cudaStream_t stream) {
  const long long pixels = static_cast<long long>(n) * h * w;
  if (pixels <= 0 || c <= 0 || c > kMaxChannels || cout <= 0 || k <= 0 || phase_s < 1 ||
      part_slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const WeightView wv{s_ky, s_kx, s_c, s_o, k, c, cout, phase_s, lo};
  int8_t* q = static_cast<int8_t*>(xq);
  int8_t* img = static_cast<int8_t*>(wimg);
  if (dtype == 0)
    return launch<float>(x, pixels, c, wt, wv, part, part_slices, wmax, amax, q, img, sw, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, pixels, c, wt, wv, part, part_slices, wmax, amax, q, img,
                                 sw, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
