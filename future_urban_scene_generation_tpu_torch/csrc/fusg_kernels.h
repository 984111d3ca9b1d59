// C interface of the port's hand-written CUDA kernels (built into one shared
// library by ops/_kernels.py and bound with ctypes). Every entry point launches
// on the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launch (0 = launched).
#pragma once

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// K1 and K1' (raster.cu): z-buffer raster of R renders in two launches, triangle
// setup (one thread per triangle) and tiles (one block per render and 16x16 tile,
// which bins for itself). `phases`: bit 0 launches the setup, bit 1 the tiles.
//   table  (R, t_pad, 32) f32 scratch: the setup's rows, read by the tiles
//   gbbox  (R, t_pad / 8, 4) f32 scratch: bbox (x0, x1, y0, y1) per 8-triangle group
//   img    (R, h, w, 3) f32 out;  bg (R, h, w) u8 out (1 = background)
//   tile_counts (R, n_tiles, 2) i32 out or null: (groups, triangles) binned per tile
// K1: screen, colors (R, 3 corners, 3 components, T) f32; cull (R,) u8 or null.
int fusg_raster_corners(const float* screen, const float* colors,
                        const unsigned char* cull, float* table, float* gbbox,
                        float* img, unsigned char* bg, int* tile_counts, int n_renders,
                        int n_tris, int h, int w, int phases, cudaStream_t stream);
// K1': verts, vert_colors (R, n_verts, 3) f32; tris (T, 3) or, tris_batched,
// (R, T, 3), int32 or, tris_int64, int64; an index outside [0, n_verts) is clamped.
int fusg_raster_indexed(const float* verts, const float* vert_colors, const void* tris,
                        int tris_int64, int tris_batched, int n_verts, float* table,
                        float* gbbox, float* img, unsigned char* bg, int* tile_counts,
                        int n_renders, int n_tris, int h, int w, int phases,
                        cudaStream_t stream);
// The launch geometry of a raster call, what ops/cuda_raster.py raster_plan mirrors:
// out[7] = t_pad, n_groups, setup grid x, tile grid x, threads a block, binning
// passes, bytes of shared memory of the tile kernel. Returns a CUDA error code.
int fusg_raster_plan(int n_tris, int h, int w, int* out);

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

// N1 (nms.cu): greedy NMS of n boxes already sorted by descending score (stable).
//   boxes_sorted (n, 4) f32 xyxy, scores_sorted (n,) f32, order (n,) i64 (original
//   index of each sorted box); mask (n, ceil(n / 64)) u64 scratch; out (max_out,) i64:
//   the first max_out kept boxes' original indices in score order, then -1. A box is
//   kept when its score > score_thr and no kept box before it has IoU > iou_thr.
//   n <= 4096 (the scan's shared memory, fusg_nms_smem_bytes(n) bytes, stays < 48 KB).
int fusg_nms(const float* boxes_sorted, const float* scores_sorted, const long long* order,
             int n, float iou_thr, float score_thr, int max_out, unsigned long long* mask,
             long long* out, cudaStream_t stream);
int fusg_nms_smem_bytes(int n);

// N2 (conv_int8.cu): int8 codes convolved with exact int32 accumulation, then
// out = float32(acc) * sw[o] as float32 (out_dtype 0) or bfloat16 (1), NHWC.
//   x (n, h, w, c) s8 with c % 16 == 0; wpk (cout, kp) s8: HWIO codes ordered
//   (ky, kx, c), zero codes past kh * kw * c up to kp (a multiple of 32); sw (cout,) f32;
//   out (n, ho, wo, cout). The conv: stride, low padding (pad_y, pad_x), dilation; the
//   transposed conv: the input dilated by in_dilation, an already flipped kernel, low
//   padding; the high side follows from (ho, wo). Not a TPU kernel port (XLA int8 conv).
int fusg_conv_int8(const void* x, const void* wpk, const float* sw, void* out, int out_dtype,
                   int n, int h, int w, int c, int kh, int kw, int cout, int ho, int wo,
                   int stride, int pad_y, int pad_x, int dil, int kp, cudaStream_t stream);
int fusg_conv_transpose_int8(const void* x, const void* wpk, const float* sw, void* out,
                             int out_dtype, int n, int h, int w, int c, int kh, int kw,
                             int cout, int ho, int wo, int in_dilation, int pad_y, int pad_x,
                             int kp, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
