// C interface of the port's hand-written CUDA kernels (built into one shared
// library by ops/_kernels.py and bound with ctypes). Every entry point launches
// on the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launch (0 = launched).
#pragma once

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// K1 (raster.cu): z-buffer raster of R renders from per-triangle plane tables.
//   table  (R, t_pad, 32) f32   planes w0,w1,w2,z,r,g,b as (A,B,C) at cols 3p..3p+2
//   bins   (R, n_tiles, n_groups) i32   per-tile ascending group bases
//   counts (R, n_tiles) i32
//   img    (R, h, w, 3) f32 out;  bg (R, h, w) u8 out (1 = background)
int fusg_raster(const float* table, const int* bins, const int* counts,
                float* img, unsigned char* bg, int n_renders, int t_pad,
                int n_groups, int h, int w, int n_tiles_y, int n_tiles_x,
                cudaStream_t stream);

// K2 (stem_conv.cu): reflect-pad + k x k stride-1 conv over the channel concat
// [sketch(3) | central(3) read at n / s_repeat | planes(3 * n_planes)], NHWC.
//   dtype 0 = float32, 1 = bfloat16 (inputs, weights and output); f32 accumulation.
//   sketch (n, h, w, 3), central (n / s_repeat, h, w, 3), planes (n, n_planes, h, w, 3)
//   wmat (k, k, cin, cout) HWIO, out (n, h_out, w_out, cout); any cout.
// The main loops (bf16: tensor cores, float32: CUDA cores) are in conv_core.cuh.
int fusg_stem_conv(const void* sketch, const void* central, const void* planes,
                   const void* wmat, void* out, int dtype, int n, int h, int w,
                   int n_planes, int k, int pad, int cout, int s_repeat,
                   cudaStream_t stream);

// K3 and K4's entry (conv_small_cin.cu): stride-1 VALID k x k conv of a pre-padded
// NHWC input, any cout. dtype 0 = float32, 1 = bfloat16 (input, weights and
// output); f32 accumulation.
//   x (n, hp, wp, cin), wmat (k, k, cin, cout) HWIO, out (n, hp-k+1, wp-k+1, cout)
int fusg_conv_small_cin(const void* x, const void* wmat, void* out, int dtype, int n,
                        int hp, int wp, int cin, int k, int cout, cudaStream_t stream);

// Bytes of dynamic shared memory a K2 / K3 launch asks for at (dtype, cin, k, cout):
// what ops/cuda_conv.py conv_plan mirrors on the Python side.
int fusg_conv_smem_bytes(int dtype, int cin, int k, int cout);

#ifdef __cplusplus
}
#endif
