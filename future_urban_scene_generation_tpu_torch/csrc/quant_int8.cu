// N3: the int8 serving tier's quantization of one conv's operands, for kernel N2
// (conv_int8.cu). Op for op the JAX package's _int8_conv / _int8_conv_transpose
// quantization (models/layers.py:195-205, :226-232), which XLA fuses around its int8
// convolution; ops/cuda_conv.py quantize_int8_plain is the same function in torch.
//   sx[c] = max(max |x[..., c]| over N, H, W, 1e-12) * float32(1 / 127)
//   w_eff = float32(w) * sx[c];  sw[o] = max(max |w_eff[..., o]|, 1e-12) * float32(1 / 127)
//   x codes = clamp(rint(x / sx), +-127),  w codes = clamp(rint(w_eff / sw), +-127)
// with IEEE division (__fdiv_rn, not a reciprocal) and round half to even (rintf), so
// the codes equal torch's and JAX's bit for bit.
//
// Two launches behind one call (after zeroing the maxima):
//   (a) per-input-channel max |x| over N*H*W: threads read neighbouring channels of a
//       pixel (16 bytes at a time where C allows, four loads in flight); about two
//       blocks an SM each reduce their rows in shared memory and merge into the global
//       maxima with atomicMax on the bit pattern of a non-negative float, which orders
//       as the float does (a NaN above infinity), so the result is exact and
//       independent of the order of the blocks;
//   (b) one pass that writes both operands of N2: the x codes (N, H, W, Cp) with the
//       channels padded to a multiple of 16 by zero codes, 16 channels a thread and one
//       16-byte store; and, one block an output channel, sw[o] from a block reduction
//       over the weight's taps and channels, then the weight codes written straight
//       into N2's B operand: the 128-byte-swizzled shared-memory image of every
//       (phase, output tile, K-block) (int8_plan.cuh), zero codes for padded channels,
//       taps and output rows. A transposed conv's weight is read flipped through
//       negative strides (no copy) and split into its phase sub-kernels here.
// What bounds it: bytes. The activation is read twice (once a launch) and its codes
// written once; the weight is small.

#include "fusg_kernels.h"
#include "int8_plan.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using namespace fusg_int8;

constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr int kThreads = 256;
constexpr int kSms = 132;  // an H100 SXM's: sizes the max pass's grid (two blocks an SM)
constexpr int kInFlight = 4;  // loads a thread of the max pass keeps in flight

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

// (a): amax[c] = max |x[p, c]| over the pixels p, as bits. Block: CT channel groups of V
// channels x (kThreads / CT) pixel rows; a thread keeps four loads in flight. About two
// blocks an SM (faster than one or four on an H100), so that a channel takes a few
// hundred atomics, not thousands.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ x, long long pixels, int c, int ct, unsigned* __restrict__ amax) {
  __shared__ unsigned red[kThreads][V];
  const int tid = threadIdx.x, groups = c / V, rows = kThreads / ct;
  const int gi = tid % ct, row = tid / ct;
  const int group = blockIdx.x * ct + gi;
  const bool active = row < rows && group < groups;
  unsigned m[V];
#pragma unroll
  for (int v = 0; v < V; ++v) m[v] = 0u;
  if (active) {
    const long long step = static_cast<long long>(gridDim.y) * rows;
    const T* src = x + static_cast<long long>(group) * V;
    long long p = static_cast<long long>(blockIdx.y) * rows + row;
    for (; p + (kInFlight - 1) * step < pixels; p += kInFlight * step) {
      float v[kInFlight][V];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) load_vec<T, V>(src + (p + u * step) * c, v[u]);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) m[e] = max(m[e], abs_bits(v[u][e]));
    }
    for (; p < pixels; p += step) {
      float v[V];
      load_vec<T, V>(src + p * c, v);
#pragma unroll
      for (int e = 0; e < V; ++e) m[e] = max(m[e], abs_bits(v[e]));
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) red[tid][v] = m[v];
  __syncthreads();
  if (tid < ct && group < groups) {
    for (int r = 1; r < rows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) m[v] = max(m[v], red[r * ct + tid][v]);
#pragma unroll
    for (int v = 0; v < V; ++v) atomicMax(amax + group * V + v, m[v]);
  }
}

struct WeightView {
  long long s_ky, s_kx, s_c, s_o;  // element strides of the HWIO view (negative: flipped)
  int k, c, cout;
  int phase_s, lo;                 // transposed conv: stride and low padding, else 1, 0
};

// (b): blocks [0, w_blocks) write one output row of the weight image each (rows past
// cout are zeros; first, so that their serial work overlaps the x codes), the rest the
// x codes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
codes_kernel(const T* __restrict__ x, long long pixels, int c, int cp, bool vec16,
             const T* __restrict__ wt, WeightView wv, Int8Plan plan,
             const unsigned* __restrict__ amax, int8_t* __restrict__ xq,
             int8_t* __restrict__ wimg, float* __restrict__ sw, int w_blocks) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= w_blocks) {
    const int chunks = cp / 16;
    const long long i = static_cast<long long>(blockIdx.x - w_blocks) * kThreads + tid;
    if (i >= pixels * chunks) return;
    const long long p = i / chunks;
    const int c0 = static_cast<int>(i % chunks) * 16;
    const T* src = x + p * c + c0;
    float v[16];
    if (vec16) {
      constexpr int N = Vec16<T>::N;
#pragma unroll
      for (int q = 0; q < 16 / N; ++q) {
        float u[N];
        Vec16<T>::load(src + N * q, u);
#pragma unroll
        for (int e = 0; e < N; ++e) v[N * q + e] = u[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = c0 + e < c ? to_f32(src[e]) : 0.f;
    }
    uint32_t packed[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = c0 + 4 * q + e;
        const int code = ch < c ? quant(v[4 * q + e], scale_of(amax[ch])) : 0;
        word |= (static_cast<uint32_t>(code) & 0xffu) << (8 * e);
      }
      packed[q] = word;
    }
    *reinterpret_cast<uint4*>(xq + p * cp + c0) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    return;
  }

  // One output row o of the weight image.
  __shared__ unsigned red[kThreads / 32];
  const int o = blockIdx.x;
  const bool real = o < wv.cout;
  float s_o = 1.f;
  if (real) {
    unsigned m = 0u;
    const int taps_c = wv.k * wv.c, n = wv.k * taps_c;
    for (int e = tid; e < n; e += kThreads) {
      const int ky = e / taps_c, rem = e % taps_c, kx = rem / wv.c, ci = rem % wv.c;
      const float w = to_f32(wt[ky * wv.s_ky + kx * wv.s_kx + ci * wv.s_c + o * wv.s_o]);
      m = max(m, abs_bits(__fmul_rn(w, scale_of(amax[ci]))));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) m = max(m, red[wi]);
    s_o = scale_of(m);
    if (tid == 0) sw[o] = s_o;
  }
  const int kchunks = plan.k_img / 16, n_kb = plan.k_img / kBK;
  const int row = o % plan.bn, o_tile = o / plan.bn;
  for (int ch = tid; ch < plan.phases * kchunks; ch += kThreads) {
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
          code = quant(__fmul_rn(w, scale_of(amax[ci])), s_o);
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
}

template <typename T>
int launch(const void* x_, long long pixels, int c, const void* wt_, const WeightView& wv,
           unsigned* amax, int8_t* xq, int8_t* wimg, float* sw, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* wt = static_cast<const T*>(wt_);
  const Int8Plan plan = int8_plan(c, wv.k, wv.cout, wv.phase_s);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * c, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kV = Vec16<T>::N;
  const bool vec = c % kV == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  const int v = vec ? kV : 1, groups = c / v;
  const int ct = groups < kThreads ? groups : kThreads;
  const int rows = kThreads / ct;
  const long long gx = (groups + ct - 1) / ct;
  long long gy = (pixels + rows - 1) / rows;
  const long long cap = 2 * kSms / gx > 1 ? 2 * kSms / gx : 1;
  if (gy > cap) gy = cap;
  const dim3 grid_a(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  if (vec) {
    amax_kernel<T, kV><<<grid_a, kThreads, 0, stream>>>(x, pixels, c, ct, amax);
  } else {
    amax_kernel<T, 1><<<grid_a, kThreads, 0, stream>>>(x, pixels, c, ct, amax);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long x_blocks = (pixels * (plan.cp / 16) + kThreads - 1) / kThreads;
  const int w_blocks = plan.o_tiles * plan.bn;
  const long long blocks = x_blocks + w_blocks;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 = c % 16 == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  codes_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, pixels, c, plan.cp, vec16, wt, wv, plan, amax, xq, wimg, sw,
      w_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fusg_quant_int8(const void* x, int dtype, int n, int h, int w, int c,
                               const void* wt, long long s_ky, long long s_kx, long long s_c,
                               long long s_o, int k, int cout, int phase_s, int lo,
                               unsigned* amax, void* xq, void* wimg, float* sw,
                               cudaStream_t stream) {
  const long long pixels = static_cast<long long>(n) * h * w;
  if (pixels <= 0 || c <= 0 || cout <= 0 || k <= 0 || phase_s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const WeightView wv{s_ky, s_kx, s_c, s_o, k, c, cout, phase_s, lo};
  int8_t* q = static_cast<int8_t*>(xq);
  int8_t* img = static_cast<int8_t*>(wimg);
  if (dtype == 0) return launch<float>(x, pixels, c, wt, wv, amax, q, img, sw, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, pixels, c, wt, wv, amax, q, img, sw, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
