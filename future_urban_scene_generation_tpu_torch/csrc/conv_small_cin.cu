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
// 256^2, 21 -> 64) against ~0.1 GB of input and output. It is bound by operations:
// 0.070 ms on the bf16 tensor cores (0.084 ms for the padded K = 1,232), 1.03 ms on
// the float32 CUDA cores.
//
// Design: K2's (csrc/stem_conv.cu) — the shared core of conv_core.cuh — with the
// single-tensor loader PaddedLoader and output-channel tiles of 64 or 16 whose
// weight slots past O are zero, so any O runs. Which bf16 shapes run on wgmma (the
// 7 x 7 stem), which on mma.sync, and which of those stage one kernel row of the
// weights at a time is decided by mma_plan() there.
#include "conv_core.cuh"
#include "fusg_kernels.h"

extern "C" int fusg_conv_small_cin(const void* x, const void* wmat, void* out, int dtype,
                                   int n, int hp, int wp, int cin, int k, int cout,
                                   cudaStream_t stream) {
  using namespace fusg_conv;
  if (n <= 0) return 0;
  const Geom g = make_geom(n, k, cin, cout, hp - k + 1, wp - k + 1);
  if (dtype == 0) {
    const PaddedLoader<float> ld{static_cast<const float*>(x), hp, wp, cin};
    return launch_fma(ld, wmat, out, g, stream);
  }
  if (dtype == 1) {
    const PaddedLoader<__nv_bfloat16> ld{static_cast<const __nv_bfloat16*>(x), hp, wp, cin};
    return launch_bf16(ld, wmat, out, g, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fusg_conv_smem_bytes(int dtype, int cin, int k, int cout) {
  return fusg_conv::smem_bytes(dtype, cin, k, cout);
}
