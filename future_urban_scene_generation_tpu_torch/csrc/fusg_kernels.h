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
//   wmat (k, k, cin, cout) HWIO, out (n, h_out, w_out, cout)
int fusg_stem_conv(const void* sketch, const void* central, const void* planes,
                   const void* wmat, void* out, int dtype, int n, int h, int w,
                   int n_planes, int k, int pad, int cout, int s_repeat,
                   cudaStream_t stream);

#ifdef __cplusplus
}
#endif
