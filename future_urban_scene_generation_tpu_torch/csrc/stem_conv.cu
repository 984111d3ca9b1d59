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
// ~0.26 GB of input and output. It is bound by operations: 0.21 ms on the bf16
// tensor cores (0.25 ms for the K = 1,232 the padded runs multiply), 3.09 ms on the
// float32 CUDA cores.
//
// Design: the shared core of conv_core.cuh (bf16: implicit GEMM by wgmma on the tensor
// cores over a sliding view of the staged patch, weights resident in shared memory,
// persistent blocks; float32: register-tiled FMA on the CUDA cores) with the loader
// that makes this kernel K2: StemLoader resolves the reflect index, the piece a
// channel lives in and the n / s_repeat repeat for every patch element, so the
// gather costs address arithmetic in the producer warps and no device memory.
#include "conv_core.cuh"
#include "fusg_kernels.h"

extern "C" int fusg_stem_conv(const void* sketch, const void* central,
                              const void* planes, const void* wmat, void* out,
                              int dtype, int n, int h, int w, int n_planes, int k,
                              int pad, int cout, int s_repeat, cudaStream_t stream) {
  using namespace fusg_conv;
  if (n <= 0) return 0;
  const Geom g = make_geom(n, k, 3 * (2 + n_planes), cout, h + 2 * pad - k + 1,
                           w + 2 * pad - k + 1);
  if (dtype == 0) {
    const StemLoader<float> ld{static_cast<const float*>(sketch),
                               static_cast<const float*>(central),
                               static_cast<const float*>(planes), h, w, n_planes, pad,
                               s_repeat};
    return launch_fma(ld, wmat, out, g, stream);
  }
  if (dtype == 1) {
    const StemLoader<__nv_bfloat16> ld{static_cast<const __nv_bfloat16*>(sketch),
                                       static_cast<const __nv_bfloat16*>(central),
                                       static_cast<const __nv_bfloat16*>(planes), h, w,
                                       n_planes, pad, s_repeat};
    return launch_bf16(ld, wmat, out, g, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
