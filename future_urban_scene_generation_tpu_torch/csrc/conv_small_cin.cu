// Kernel K3 (and K4's entry): stride-1 VALID convolution of a pre-padded NHWC
// input with an HWIO kernel, any number of output channels; float32 accumulation,
// output in the input dtype.
//
// Replaces the TPU kernels future_urban_scene_generation_tpu/ops/pallas_conv.py
// _conv_kernel_v2 (reached through conv_small_cin_v2) and _conv_kernel (reached
// through conv_small_cin): two TPU layouts of one function, so one CUDA kernel
// serves both entries. The JAX package routes every gated conv here
// (models/layers._dispatch_conv_impl); in the stock networks that is the ICN stem
// in GResnet's full forward — the ICN trainer's generator.
//
// What bounds it on an H100: an implicit GEMM of M = N*Ho*Wo pixels, K = k*k*C
// (1,029 for the ICN stem) and O outputs — 69 GFLOP for the training stem (batch 8,
// 256^2, 21 -> 64) against ~0.2 GB of input and output, so it is compute-bound.
// This first version runs on the CUDA cores in float32 (bf16 inputs are widened on
// load), held to the FP32 rate; wgmma/TMA tiling is later work.
//
// Design (K2's, csrc/stem_conv.cu, with a single-tensor loader and an output-channel
// tile): one block of 256 threads per (sample, output-channel tile of OT, 16x16
// output tile), one thread per output pixel holding OT float32 accumulators in
// registers. The tile's input patch ((16+k-1)^2 x C, float32) is staged once in
// shared memory; the weights one kernel row (ky) at a time, k*C*OT floats, with the
// channels past O zero-filled so any O works. For the largest shape the gate admits
// (k = 9, C = 32, OT = 64) that is 72 KB + 72 KB, above the 48 KB static limit, so
// the launch opts in to dynamic shared memory.
#include <cuda_bf16.h>

#include "fusg_kernels.h"

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

template <typename T, int OT>
__global__ void __launch_bounds__(kThreads)
conv_small_cin_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
                      T* __restrict__ out, int hp, int wp, int cin, int k, int cout,
                      int h_out, int w_out, int n_otiles) {
  extern __shared__ __align__(16) float smem[];
  const int pw = kTile + k - 1;
  const int patch_elems = pw * pw * cin;
  float* patch = smem;
  float* wrow = smem + round4(patch_elems);

  const int n = blockIdx.z / n_otiles;
  const int o0 = (blockIdx.z % n_otiles) * OT;
  const int ox0 = blockIdx.x * kTile;
  const int oy0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;

  // Positions past a ragged tile edge (whose outputs are discarded) are clamped
  // into the padded input.
  const T* xn = x + static_cast<size_t>(n) * hp * wp * cin;
  for (int idx = tid; idx < patch_elems; idx += kThreads) {
    const int c = idx % cin;
    const int rest = idx / cin;
    const int iy = min(oy0 + rest / pw, hp - 1);
    const int ix = min(ox0 + rest % pw, wp - 1);
    patch[idx] = to_f32(xn[(static_cast<size_t>(iy) * wp + ix) * cin + c]);
  }

  float acc[OT];
#pragma unroll
  for (int o = 0; o < OT; ++o) acc[o] = 0.f;

  const int tx = tid % kTile;
  const int ty = tid / kTile;
  const int row_elems = k * cin * OT;
  for (int ky = 0; ky < k; ++ky) {
    __syncthreads();  // patch staged / previous weight row consumed
    // wrow[(kx * cin + ci) * OT + o] = w[ky, kx, ci, o0 + o], 0 past O.
    const T* wsrc = wmat + static_cast<size_t>(ky) * k * cin * cout + o0;
    for (int idx = tid; idx < row_elems; idx += kThreads) {
      const int o = idx % OT;
      const int r = idx / OT;
      wrow[idx] = (o0 + o < cout) ? to_f32(wsrc[static_cast<size_t>(r) * cout + o]) : 0.f;
    }
    __syncthreads();
    for (int kx = 0; kx < k; ++kx) {
      const float* a_ptr = patch + ((ty + ky) * pw + (tx + kx)) * cin;
      const float* w_ptr = wrow + kx * cin * OT;
      for (int ci = 0; ci < cin; ++ci) {
        const float a = a_ptr[ci];
        const float4* w4 = reinterpret_cast<const float4*>(w_ptr + ci * OT);
#pragma unroll
        for (int q = 0; q < OT / 4; ++q) {
          const float4 wv = w4[q];
          acc[4 * q + 0] = fmaf(a, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(a, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a, wv.w, acc[4 * q + 3]);
        }
      }
    }
  }

  const int ox = ox0 + tx;
  const int oy = oy0 + ty;
  if (ox < w_out && oy < h_out) {
    T* dst = out + ((static_cast<size_t>(n) * h_out + oy) * w_out + ox) * cout + o0;
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      if (o0 + o < cout) store(dst + o, acc[o]);
    }
  }
}

template <typename T, int OT>
int launch(const void* x, const void* wmat, void* out, int n, int hp, int wp, int cin,
           int k, int cout, cudaStream_t stream) {
  const int pw = kTile + k - 1;
  const int h_out = hp - k + 1;
  const int w_out = wp - k + 1;
  const int n_otiles = (cout + OT - 1) / OT;
  const size_t smem =
      (static_cast<size_t>(round4(pw * pw * cin)) + static_cast<size_t>(k) * cin * OT) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conv_small_cin_kernel<T, OT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w_out + kTile - 1) / kTile, (h_out + kTile - 1) / kTile, n * n_otiles);
  conv_small_cin_kernel<T, OT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmat), static_cast<T*>(out), hp, wp,
      cin, k, cout, h_out, w_out, n_otiles);
  return static_cast<int>(cudaGetLastError());
}

// Output-channel tile: 64 (K2's width) for wide outputs, 16 otherwise.
template <typename T>
int dispatch_tile(const void* x, const void* wmat, void* out, int n, int hp, int wp,
                  int cin, int k, int cout, cudaStream_t stream) {
  if (cout >= 64) return launch<T, 64>(x, wmat, out, n, hp, wp, cin, k, cout, stream);
  return launch<T, 16>(x, wmat, out, n, hp, wp, cin, k, cout, stream);
}

}  // namespace

extern "C" int fusg_conv_small_cin(const void* x, const void* wmat, void* out, int dtype,
                                   int n, int hp, int wp, int cin, int k, int cout,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  if (dtype == 0)
    return dispatch_tile<float>(x, wmat, out, n, hp, wp, cin, k, cout, stream);
  if (dtype == 1)
    return dispatch_tile<__nv_bfloat16>(x, wmat, out, n, hp, wp, cin, k, cout, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
