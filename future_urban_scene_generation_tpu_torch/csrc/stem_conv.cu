// Kernel K2: the ICN stem — reflect-pad, then a k x k stride-1 convolution over
// the 21-channel concat [dst sketch LAB (3) | central patch LAB (3) | 5 warped
// planes LAB (15)] assembled inside the kernel from three tensors.
//
// Replaces the TPU kernel future_urban_scene_generation_tpu/ops/pallas_conv.py
// (_conv_kernel_v2_fused, reached through icn_stem_conv_fused). As there, the
// concat, its reflect padding and the per-vehicle repeat of the central patch
// (read at n / s_repeat) never reach device memory; accumulation is float32 and
// the bias, instance norm and ReLU follow in torch.
//
// What bounds it on an H100: an implicit GEMM of M = N*H*W pixels, K = k*k*21 =
// 1,029 and 64 output channels — 207 GFLOP at the scene's N = 24, 256^2, against
// ~0.15 GB of input and output. It is compute-bound. This first version runs on
// the CUDA cores in float32 (bf16 inputs are widened on load), so it is held to the
// FP32 rate, far below the tensor cores; wgmma/TMA tiling is later work.
//
// Design: one block of 256 threads per (sample, 16x16 output tile), one thread per
// output pixel holding all COUT accumulators in registers. The tile's input patch
// ((16+k-1)^2 x 21 channels, reflect indices resolved, float32) is staged once in
// shared memory; the weights are staged one kernel row (ky) at a time — k*21*COUT
// floats, 37.6 KB for the stock stem — because the whole 1,029 x 64 matrix (263 KB
// in float32) does not fit. Each weight read is a float4 broadcast to the warp.
// The patch plus one weight row is 78 KB, above the 48 KB static limit, so the
// launch opts in to dynamic shared memory.
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

// torch.nn.ReflectionPad2d / numpy "reflect" index for pad < n; positions past a
// ragged tile edge (whose outputs are discarded) are clamped into range.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const T* __restrict__ sketch, const T* __restrict__ central,
                 const T* __restrict__ planes, const T* __restrict__ wmat,
                 T* __restrict__ out, int h, int w, int h_out, int w_out,
                 int n_planes, int k, int pad, int s_repeat) {
  extern __shared__ __align__(16) float smem[];
  const int cin = 3 * (2 + n_planes);
  const int pw = kTile + k - 1;
  const int patch_elems = pw * pw * cin;
  float* patch = smem;
  float* wrow = smem + round4(patch_elems);

  const int n = blockIdx.z;
  const int ox0 = blockIdx.x * kTile;
  const int oy0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;

  const T* sk = sketch + static_cast<size_t>(n) * h * w * 3;
  const T* ce = central + static_cast<size_t>(n / s_repeat) * h * w * 3;
  const T* pl = planes + static_cast<size_t>(n) * n_planes * h * w * 3;
  for (int idx = tid; idx < patch_elems; idx += kThreads) {
    const int c = idx % cin;
    const int rest = idx / cin;
    const int px = rest % pw;
    const int py = rest / pw;
    const int iy = reflect(oy0 + py - pad, h);
    const int ix = reflect(ox0 + px - pad, w);
    const size_t pix = static_cast<size_t>(iy) * w + ix;
    float v;
    if (c < 3) {
      v = to_f32(sk[pix * 3 + c]);
    } else if (c < 6) {
      v = to_f32(ce[pix * 3 + (c - 3)]);
    } else {
      const int q = c - 6;
      v = to_f32(pl[(static_cast<size_t>(q / 3) * h * w + pix) * 3 + (q % 3)]);
    }
    patch[idx] = v;
  }

  float acc[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) acc[o] = 0.f;

  const int tx = tid % kTile;
  const int ty = tid / kTile;
  const int row_elems = k * cin * COUT;
  for (int ky = 0; ky < k; ++ky) {
    __syncthreads();  // patch staged / previous weight row consumed
    const T* wsrc = wmat + static_cast<size_t>(ky) * row_elems;
    for (int idx = tid; idx < row_elems; idx += kThreads) wrow[idx] = to_f32(wsrc[idx]);
    __syncthreads();
    for (int kx = 0; kx < k; ++kx) {
      const float* a_ptr = patch + ((ty + ky) * pw + (tx + kx)) * cin;
      const float* w_ptr = wrow + kx * cin * COUT;
      for (int ci = 0; ci < cin; ++ci) {
        const float a = a_ptr[ci];
        const float4* w4 = reinterpret_cast<const float4*>(w_ptr + ci * COUT);
#pragma unroll
        for (int q = 0; q < COUT / 4; ++q) {
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
    T* dst = out + ((static_cast<size_t>(n) * h_out + oy) * w_out + ox) * COUT;
#pragma unroll
    for (int o = 0; o < COUT; ++o) store(dst + o, acc[o]);
  }
}

template <typename T, int COUT>
int launch(const void* sketch, const void* central, const void* planes,
           const void* wmat, void* out, int n, int h, int w, int n_planes, int k,
           int pad, int s_repeat, cudaStream_t stream) {
  const int cin = 3 * (2 + n_planes);
  const int pw = kTile + k - 1;
  const int h_out = h + 2 * pad - k + 1;
  const int w_out = w + 2 * pad - k + 1;
  const size_t smem =
      (static_cast<size_t>(round4(pw * pw * cin)) + static_cast<size_t>(k) * cin * COUT) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stem_conv_kernel<T, COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w_out + kTile - 1) / kTile, (h_out + kTile - 1) / kTile, n);
  stem_conv_kernel<T, COUT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(sketch), static_cast<const T*>(central),
      static_cast<const T*>(planes), static_cast<const T*>(wmat),
      static_cast<T*>(out), h, w, h_out, w_out, n_planes, k, pad, s_repeat);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_cout(const void* sketch, const void* central, const void* planes,
                  const void* wmat, void* out, int n, int h, int w, int n_planes,
                  int k, int pad, int cout, int s_repeat, cudaStream_t stream) {
  switch (cout) {
    case 8:
      return launch<T, 8>(sketch, central, planes, wmat, out, n, h, w, n_planes, k, pad,
                          s_repeat, stream);
    case 16:
      return launch<T, 16>(sketch, central, planes, wmat, out, n, h, w, n_planes, k,
                           pad, s_repeat, stream);
    case 64:
      return launch<T, 64>(sketch, central, planes, wmat, out, n, h, w, n_planes, k,
                           pad, s_repeat, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fusg_stem_conv(const void* sketch, const void* central,
                              const void* planes, const void* wmat, void* out,
                              int dtype, int n, int h, int w, int n_planes, int k,
                              int pad, int cout, int s_repeat, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (dtype == 0)
    return dispatch_cout<float>(sketch, central, planes, wmat, out, n, h, w, n_planes,
                                k, pad, cout, s_repeat, stream);
  if (dtype == 1)
    return dispatch_cout<__nv_bfloat16>(sketch, central, planes, wmat, out, n, h, w,
                                        n_planes, k, pad, cout, s_repeat, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
