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

// N1 (nms.cu): greedy NMS of n_segments (<= 16) independent runs of boxes, each in
// the order the greedy pass visits it (descending score), in one launch: a thread-block
// cluster of 16 blocks a segment.
//   boxes (N, 4) f32 xyxy, 16-byte aligned; scores (N,) f32; segment s: boxes
//   [seg_start[s], seg_start[s] + seg_len[s]), seg_len[s] <= 4096, its output
//   out[out_start[s] .. + max_out[s]) i64: the first max_out[s] kept boxes' positions in
//   the segment, then -1; its overlap mask in rank 0's shared memory (scratch_start[s] =
//   -1, seg_len[s] <= 1024) or at word scratch_start[s] of `scratch` (seg_len *
//   ceil(seg_len / 64) u64). A box is kept when its score > score_thr and no kept box
//   before it has IoU > iou_thr. The host arrays are read during the call.
int fusg_nms_segments(const float* boxes, const float* scores, int n_segments,
                      const int* seg_start, const int* seg_len, const int* out_start,
                      const int* max_out, const long long* scratch_start, float iou_thr,
                      float score_thr, unsigned long long* scratch, long long* out,
                      cudaStream_t stream);

// N2 (conv_int8.cu): int8 codes convolved with exact int32 accumulation, then
// out = float32(acc) * sw[o] as float32 (out_dtype 0) or bfloat16 (1), NHWC.
//   x (n, h, w, round16(c)) s8; wimg: the weight codes as N3 writes them, the
//   128-byte-swizzled image of every (phase, output tile, K-block) tile
//   (int8_plan.cuh); sw (cout,) f32; out (n, ho, wo, cout). The conv: k x k, stride,
//   low padding (pad_y, pad_x), dilation; the transposed conv of stride s (the kernel
//   flipped, low padding lo = k - 1 - p): s * s phase convs of the undilated input. The
//   high side follows from (ho, wo). Not a TPU kernel port (XLA int8 conv).
int fusg_conv_int8(const void* x, const void* wimg, const float* sw, void* out, int out_dtype,
                   int n, int h, int w, int c, int k, int cout, int ho, int wo, int stride,
                   int pad_y, int pad_x, int dil, cudaStream_t stream);
int fusg_conv_transpose_int8(const void* x, const void* wimg, const float* sw, void* out,
                             int out_dtype, int n, int h, int w, int c, int k, int cout,
                             int ho, int wo, int stride, int lo_y, int lo_x,
                             cudaStream_t stream);
// The plan of a conv of c input and cout output channels (phase_s: the transposed
// conv's stride, else 1), what ops/cuda_conv.py int8_plan mirrors: out[9] = bn, bk,
// stages, smem, phases, taps, cp, k_img, o_tiles.
int fusg_int8_plan(int c, int k, int cout, int phase_s, int* out);

// N3 (quant_int8.cu): the int8 tier's quantization of one conv's operands for N2.
//   x (n, h, w, c) f32 (dtype 0) or bf16 (1), contiguous, c <= 2048; wt: the HWIO
//   kernel in x's dtype at element strides (s_ky, s_kx, s_c, s_o), negative for a
//   flipped view; part (c, part_slices) u32 scratch, part_slices >= the SM count x
//   fusg_quant_int8_slices(); wmax (cout, c) and amax (c,) u32 scratch; xq (n, h, w,
//   round16(c)) s8 out;
//   wimg (phases * o_tiles * k_img * bn) s8 out; sw (cout,) f32 out. phase_s, lo: a
//   transposed conv's stride and low padding (1, 0 for the conv). One cooperative
//   launch; no scratch needs zeroing.
int fusg_quant_int8(const void* x, int dtype, int n, int h, int w, int c, const void* wt,
                    long long s_ky, long long s_kx, long long s_c, long long s_o, int k,
                    int cout, int phase_s, int lo, unsigned* part, int part_slices,
                    unsigned* wmax, unsigned* amax, void* xq, void* wimg, float* sw,
                    cudaStream_t stream);
// Blocks an SM N3 launches at most (its partials' slices an SM).
int fusg_quant_int8_slices(void);

#ifdef __cplusplus
}
#endif
