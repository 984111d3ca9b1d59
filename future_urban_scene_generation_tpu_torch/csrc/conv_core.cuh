// Shared core of the small-C_in stem convolutions (kernels K2, K3 and K4's entry):
// a k x k stride-1 convolution of an NHWC input with an HWIO kernel, float32
// accumulation, output in the input dtype. One main loop per dtype, templated on
// a patch loader; stem_conv.cu instantiates it with the fused three-tensor reflect
// loader (K2), conv_small_cin.cu with the single-tensor loader (K3 / K4).
//
// Replaces the bodies of the TPU kernels in
// future_urban_scene_generation_tpu/ops/pallas_conv.py (_conv_kernel_v2_fused,
// _conv_kernel_v2, _conv_kernel).
//
// What bounds the function on an H100: an implicit GEMM with M = N*Ho*Wo pixels,
// K = k*k*C (1,029 for the ICN stem) and O outputs: ~130 FLOP per byte moved in bf16,
// so it is bound by operations — the tensor cores in bf16, the CUDA cores in float32
// (true float32: no TF32).
//
// bfloat16 — tensor cores, two kernels that share everything but the product
// (mma_plan() decides, ops/cuda_conv.py conv_plan mirrors it): conv_wgmma_kernel
// (wgmma.mma_async.m64n64k16; 7 x 7 kernels, 64-channel tiles, weights resident: the
// stems) and conv_mma_kernel (mma.sync.m16n8k16; every other shape).
//   * The A operand is a sliding view of the input patch, never an im2col buffer.
//     A 16x16 output tile's patch is staged as bf16 NHWC with the channels padded to
//     CP = round8(C) (a pixel is then a multiple of 16 bytes, so ldmatrix rows are
//     aligned, and for CP = 24 eight consecutive pixels fall on eight distinct
//     16-byte bank groups; CP = 16 and 32 take 2- and 4-way conflicts). For a fixed
//     ky the K-run of output pixel (y, x) is the contiguous span
//     patch[y+ky][x .. x+k-1][0 .. CP-1]; the next pixel's run starts CP elements
//     later. The run is rounded up to KR = round16(k*CP); the 0 or 8 extra elements
//     belong to the next pixel, the next patch row or a 16-byte tail, and meet zero
//     weight rows. Padded channels and the tail are written as zeros (0 x NaN is
//     NaN); inputs are taken to be finite.
//   * The B operand is packed by the kernel itself, zero rows and zero columns past O
//     included. mma.sync: [ky][KR][NT + 8] bf16 (NT = 64 or 16 output channels a
//     block; the 8-element row pad keeps ldmatrix.trans off bank conflicts), resident
//     where k * KR * (NT + 8) * 2 bytes fit beside two patch buffers in the 232,448
//     bytes a block may use, else (e.g. k = 9, C = 32, O-tile 64) one ky row at a
//     time. wgmma: 8 x 8 core matrices, 2,048 bytes per 16-deep step, always
//     resident (the ICN stem: 157,696 + 2 * 23,248 = 204,192 bytes).
//   * Persistent blocks, one per SM, walk the output tiles: 8 consumer warps and 4
//     producer warps that gather the next tile's patch into the second buffer
//     meanwhile, a pixel a thread, with plain 2-byte loads (a bf16 pixel of 21
//     channels is 42 bytes: no alignment for cp.async or wider loads) and 16-byte
//     shared-memory stores. mma.sync: a warp owns 2 tile rows = 32 pixels x NT
//     channels; per 16-deep step 2 ldmatrix.x4 for A and NT/16 ldmatrix.x4.trans for
//     B feed NT/4 mma, the next step's fragments loaded while the current step
//     multiplies. wgmma: see conv_wgmma_kernel.
//   * Epilogue: two butterfly shuffles inside each quad turn the fragments' column
//     pairs into 16 contiguous channels a lane, so a pixel's 64 channels leave as
//     128 contiguous bytes; ragged O takes 4- or 2-byte stores.
//   * What holds it: shared-memory bandwidth for the operands. mma.sync reads
//     (2 + NT/16) * 512 B per NT/4 * 4,096 FMA a warp, about 1.5 shared-memory cycles
//     per tensor-core cycle at NT = 64; four tile rows a warp (a third less traffic,
//     but only 4 mma warps) measured slower. wgmma reads B once per warpgroup and
//     each A fragment once for two products: about 0.8 cycles per tensor-core cycle.
//
// float32 — conv_fma_kernel, CUDA cores: one block of 128 threads per (sample,
//   output-channel tile, 16x16 output tile), two blocks an SM. Each thread owns 8
//   pixels (one column of 8 tile rows) x 16 channels in registers (NT = 64; 4 x 8 at
//   NT = 16), so one weight float4 (a broadcast) feeds 8 pixels and one activation 16
//   channels: 12 shared-memory loads per 128 FMA. The patch is staged once with an
//   odd pixel pitch (conflict-free for any C); the weights travel as (ky, kx) taps
//   of C x NT floats through a ring of four cp.async stages (16-byte copies where O
//   allows, zero-fill past O), so a tap is copied two taps of FMAs ahead and the
//   one barrier per tap finds it landed. What holds it: instruction slots and the
//   shared-memory pipe beside the FMAs (233 registers, 8 warps an SM).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fusg_conv {

constexpr int kTile = 16;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use
constexpr int kWgmmaK = 7;  // the kernel size conv_wgmma_kernel is instantiated for

struct Geom {
  int n, k, cin, cout;
  int h_out, w_out, tiles_x, tiles_y;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---------------------------------------------------------------- loaders ----
// A loader resolves a position (sample, row, column) of the conv's padded input once
// (`pixel`) and then gives the address of each of its channels (`at`). Addresses are
// always valid: positions past a ragged tile edge (whose outputs are discarded) are
// clamped into range.

// K3 / K4: one pre-padded NHWC tensor.
template <typename T>
struct PaddedLoader {
  const T* x;
  int hp, wp, cin;
  struct Pixel {
    const T* p;
  };
  __device__ __forceinline__ Pixel pixel(int n, int y, int xx) const {
    const int iy = min(y, hp - 1), ix = min(xx, wp - 1);
    return {x + ((static_cast<size_t>(n) * hp + iy) * wp + ix) * cin};
  }
  __device__ __forceinline__ const T* at(const Pixel& px, int c) const { return px.p + c; }
};

// K2: the concat [sketch (3) | central (3), read at n / s_repeat | planes (3 each)]
// with reflect padding (torch ReflectionPad2d / numpy "reflect"), resolved here.
template <typename T>
struct StemLoader {
  const T* sketch;
  const T* central;
  const T* planes;
  int h, w, n_planes, pad, s_repeat;
  struct Pixel {
    const T* sk;
    const T* ce;
    const T* pl;
  };
  static __device__ __forceinline__ int reflect(int i, int n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
    return min(max(i, 0), n - 1);
  }
  __device__ __forceinline__ Pixel pixel(int n, int y, int xx) const {
    const size_t hw3 = static_cast<size_t>(h) * w * 3;
    const size_t pix3 = (static_cast<size_t>(reflect(y - pad, h)) * w + reflect(xx - pad, w)) * 3;
    return {sketch + n * hw3 + pix3, central + (n / s_repeat) * hw3 + pix3,
            planes + static_cast<size_t>(n) * n_planes * hw3 + pix3};
  }
  __device__ __forceinline__ const T* at(const Pixel& px, int c) const {
    if (c < 3) return px.sk + c;
    if (c < 6) return px.ce + (c - 3);
    const int q = c - 6;
    return px.pl + (q / 3) * (static_cast<size_t>(h) * w * 3) + (q % 3);
  }
};

// ------------------------------------------------------------------ plans ----
// Shared-memory plan of the bf16 kernel (mirrored by ops/cuda_conv.py conv_plan).
struct MmaPlan {
  int cp, kr, nt, patch_bytes, wrow_bytes, resident, wgmma, smem;
};

inline MmaPlan mma_plan(int cin, int k, int cout) {
  MmaPlan p;
  p.cp = round_up(cin, 8);
  p.kr = round_up(k * p.cp, 16);
  p.nt = cout > 16 ? 64 : 16;
  const int pw = kTile + k - 1;
  p.patch_bytes = pw * pw * p.cp * 2 + 16;  // + the 16-byte zero tail
  // wgmma: k = 7 and 64-channel tiles whose whole matrix fits, 2,048 bytes a 16-deep step.
  const long long wg_full = static_cast<long long>(k) * (p.kr / 16) * 2048 + 2LL * p.patch_bytes;
  p.wgmma = p.nt == 64 && k == kWgmmaK && wg_full <= kSmemLimit;
  if (p.wgmma) {
    p.wrow_bytes = p.kr * 128;
    p.resident = 1;
    p.smem = static_cast<int>(wg_full);
    return p;
  }
  // mma.sync: rows of nt + 8 elements, resident where they fit, else a ky row at a time.
  p.wrow_bytes = p.kr * (p.nt + 8) * 2;
  const long long full = static_cast<long long>(k) * p.wrow_bytes + 2LL * p.patch_bytes;
  p.resident = full <= kSmemLimit;
  p.smem = p.resident ? static_cast<int>(full) : p.wrow_bytes + 2 * p.patch_bytes;
  return p;
}

// Shared-memory plan of the float32 kernel: the patch and a ring of kFmaStages
// (ky, kx) weight taps of cin x nt floats.
constexpr int kFmaStages = 4;
struct FmaPlan {
  int nt, pitch, patch_floats, smem;
};

inline FmaPlan fma_plan(int cin, int k, int cout) {
  FmaPlan p;
  p.nt = cout > 16 ? 64 : 16;
  const int pw = kTile + k - 1;
  p.pitch = cin | 1;
  p.patch_floats = round_up(pw * pw * p.pitch, 4);
  p.smem = (p.patch_floats + kFmaStages * cin * p.nt) * 4;
  return p;
}

// ------------------------------------------------------------- primitives ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid (src is then
// not read but must still be an address inside an allocation).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The same for 16 bytes (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// ------------------------------------------------------------ bf16 kernel ----
constexpr int kRowsPerWarp = 2;  // tile rows (m16-tiles) a consumer warp owns
constexpr int kConsumers = 32 * kTile / kRowsPerWarp;  // 8 warps of mma
constexpr int kProducers = 128;  // 4 warps that stage the next patch
constexpr int kMmaThreads = kConsumers + kProducers;

// Stages the (pw x pw x cp) patch of the tile at (n, oy0, ox0), a pixel a thread:
// eight channel loads in flight, then one 16-byte store; channels past cin are zeros.
template <typename Loader>
__device__ __forceinline__ void fill_patch_bf16(const Loader& ld, __nv_bfloat16* buf, int n,
                                                int oy0, int ox0, int pw, int cin, int cp,
                                                int tid, int nthreads) {
  const int npix = pw * pw;
  for (int p = tid; p < npix; p += nthreads) {
    const auto px = ld.pixel(n, oy0 + p / pw, ox0 + p % pw);
    uint4* dst = reinterpret_cast<uint4*>(buf + p * cp);
    // cp <= 32 here: all of the pixel's loads are in flight before its stores.
    alignas(16) __nv_bfloat16 v[4][8];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = ch * 8 + u;
        v[ch][u] = c < cin ? *ld.at(px, c) : __float2bfloat16_rn(0.f);
      }
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (ch * 8 < cp) dst[ch] = *reinterpret_cast<const uint4*>(v[ch]);
    }
    for (int c0 = 32; c0 < cp; c0 += 8) {  // wider inputs: a chunk at a time
      alignas(16) __nv_bfloat16 t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        t[u] = c0 + u < cin ? *ld.at(px, c0 + u) : __float2bfloat16_rn(0.f);
      }
      dst[c0 >> 3] = *reinterpret_cast<const uint4*>(t);
    }
  }
}

// Packs `rows` ky rows of the weights from ky0 on as [row][kr][wpitch] bf16:
// wsm[(r * kr + kx * cp + c) * wpitch + o] = w[ky0 + r][kx][c][o0 + o], zero where
// kx >= k (the run's round-up), c >= cin (the channel pad) or o0 + o >= cout.
// Eight channels a copy where O is a multiple of 8 and the matrix is 16-byte aligned.
__device__ __forceinline__ void pack_weights_bf16(const __nv_bfloat16* __restrict__ wmat,
                                                  __nv_bfloat16* wsm, int ky0, int rows,
                                                  int k, int cin, int cp, int kr, int cout,
                                                  int o0, int nt, int wpitch, int tid,
                                                  int nthreads) {
  if ((cout & 7) == 0 && (reinterpret_cast<uintptr_t>(wmat) & 15) == 0) {
    const int chunks = nt >> 3;
    const int total = rows * kr * chunks;
    for (int idx = tid; idx < total; idx += nthreads) {
      const int o = o0 + (idx % chunks) * 8;
      const int r = idx / chunks;  // row of the packed matrix
      const int j = r % kr;
      const int ky = ky0 + r / kr;
      const int kx = j / cp;
      const int c = j % cp;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (kx < k && c < cin && o < cout) {
        v = *reinterpret_cast<const uint4*>(
            wmat + (static_cast<size_t>(ky * k + kx) * cin + c) * cout + o);
      }
      *reinterpret_cast<uint4*>(wsm + r * wpitch + (o - o0)) = v;
    }
    return;
  }
  const int total = rows * kr * nt;
  for (int idx = tid; idx < total; idx += nthreads) {
    const int o = idx % nt;
    const int r = idx / nt;
    const int j = r % kr;
    const int ky = ky0 + r / kr;
    const int kx = j / cp;
    const int c = j % cp;
    const bool real = kx < k && c < cin && o0 + o < cout;
    wsm[r * wpitch + o] =
        real ? wmat[(static_cast<size_t>(ky * k + kx) * cin + c) * cout + o0 + o]
             : __float2bfloat16_rn(0.f);
  }
}

// The operand fragments of one 16-deep step of a warp: A for its two tile rows, B
// for all NT8 n8-tiles.
template <int MT, int NT8>
struct Frags {
  uint32_t a[MT][4];
  uint32_t b[NT8 / 2][4];
};

template <int MT, int NT8>
__device__ __forceinline__ void load_frags(Frags<MT, NT8>& f, uint32_t a_addr, uint32_t a_row,
                                           uint32_t b_addr) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(f.a[mt], a_addr + mt * a_row);
#pragma unroll
  for (int np = 0; np < NT8 / 2; ++np) ldmatrix_x4_trans(f.b[np], b_addr + np * 32);
}

template <int MT, int NT8>
__device__ __forceinline__ void mma_frags(float (&acc)[MT][NT8][4], const Frags<MT, NT8>& f) {
#pragma unroll
  for (int np = 0; np < NT8 / 2; ++np) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * np], f.a[mt], f.b[np][0], f.b[np][1]);
      mma_bf16(acc[mt][2 * np + 1], f.a[mt], f.b[np][2], f.b[np][3]);
    }
  }
}

// nky kernel rows of ksteps 16-deep steps each, the next step's fragments loaded
// while the current step multiplies. a_addr: this lane's ldmatrix address at the
// first row's first step (rows are a_row bytes apart, steps 32 bytes); b_addr: the
// same for the packed weights, whose steps are contiguous (b_step bytes apart).
template <int MT, int NT8>
__device__ __forceinline__ void mma_rows(float (&acc)[MT][NT8][4], uint32_t a_addr,
                                         uint32_t a_row, uint32_t b_addr, uint32_t b_step,
                                         int nky, int ksteps) {
  const int total = nky * ksteps;
  int ks = 0;
  auto advance = [&]() {
    a_addr += 32;
    b_addr += b_step;
    if (++ks == ksteps) {
      ks = 0;
      a_addr += a_row - ksteps * 32;
    }
  };
  Frags<MT, NT8> f0, f1;
  load_frags(f0, a_addr, a_row, b_addr);
  advance();
  for (int s = 0; s < total; s += 2) {
    if (s + 1 < total) {
      load_frags(f1, a_addr, a_row, b_addr);
      advance();
    }
    mma_frags(acc, f0);
    if (s + 2 < total) {
      load_frags(f0, a_addr, a_row, b_addr);
      advance();
    }
    if (s + 1 < total) mma_frags(acc, f1);
  }
}

// Rounds a warp's accumulators to bf16 and stores them: m16-tile mt is tile row
// rows[mt] (16 pixels), its NT8 n8-tiles the channels o0 .. o0 + 8 * NT8 - 1.
template <int MT, int NT8>
__device__ __forceinline__ void store_tile_bf16(const float (&acc)[MT][NT8][4],
                                                const int (&rows)[MT],
                                                __nv_bfloat16* __restrict__ out, const Geom& g,
                                                int n, int oy0, int ox0, int o0, int lane) {
  constexpr int NT = NT8 * 8;
  const int gq = lane >> 2, tq = lane & 3;
  const bool pairs = (g.cout & 1) == 0;
  const bool vec16 = NT8 == 8 && (g.cout & 7) == 0 && o0 + NT <= g.cout &&
                     (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vec16) {
    // Full 64-channel tiles: two butterfly exchanges inside each quad turn the
    // fragment's column pairs into 16 contiguous channels a lane, so a pixel
    // goes out as 128 contiguous bytes (two 16-byte stores a lane).
    const bool hi = (tq & 2) != 0, lo = (tq & 1) != 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int oy = oy0 + rows[mt];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t w[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][nt % NT8][2 * half],
                                                         acc[mt][nt % NT8][2 * half + 1]);
          w[nt] = *reinterpret_cast<const uint32_t*>(&v);
        }
        uint32_t y[2][4];  // [source lane bit 1][2 * (n-tile pair bit 0) + element]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t keep = hi ? w[4 + i] : w[i];
          const uint32_t recv = __shfl_xor_sync(0xffffffffu, hi ? w[i] : w[4 + i], 2);
          y[0][i] = hi ? recv : keep;
          y[1][i] = hi ? keep : recv;
        }
        uint32_t z[2][2][2];  // [source bit 1][source bit 0][element]
#pragma unroll
        for (int sb = 0; sb < 2; ++sb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t keep = lo ? y[sb][2 + e] : y[sb][e];
            const uint32_t recv =
                __shfl_xor_sync(0xffffffffu, lo ? y[sb][e] : y[sb][2 + e], 1);
            z[sb][0][e] = lo ? recv : keep;
            z[sb][1][e] = lo ? keep : recv;
          }
        const int ox = ox0 + gq + 8 * half;
        if (oy < g.h_out && ox < g.w_out) {
          uint4* dst = reinterpret_cast<uint4*>(
              out + ((static_cast<size_t>(n) * g.h_out + oy) * g.w_out + ox) * g.cout + o0 +
              16 * tq);
          dst[0] = make_uint4(z[0][0][0], z[0][1][0], z[1][0][0], z[1][1][0]);
          dst[1] = make_uint4(z[0][0][1], z[0][1][1], z[1][0][1], z[1][1][1]);
        }
      }
    }
  } else {
    // Ragged O (or a partial channel tile): the column pairs as 4-byte stores,
    // single elements where O is odd.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int oy = oy0 + rows[mt];
      if (oy >= g.h_out) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = ox0 + gq + 8 * half;
        if (ox >= g.w_out) continue;
        __nv_bfloat16* dst =
            out + ((static_cast<size_t>(n) * g.h_out + oy) * g.w_out + ox) * g.cout;
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          const int o = o0 + nt * 8 + 2 * tq;
          const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
          if (pairs && o + 1 < g.cout) {
            *reinterpret_cast<__nv_bfloat162*>(dst + o) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (o < g.cout) dst[o] = __float2bfloat16_rn(v0);
            if (o + 1 < g.cout) dst[o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// NT8: n8-tiles of output channels per block (8 -> 64 channels, 2 -> 16).
template <typename Loader, int NT8>
__global__ void __launch_bounds__(kMmaThreads, 1)
conv_mma_kernel(Loader ld, const __nv_bfloat16* __restrict__ wmat,
                __nv_bfloat16* __restrict__ out, Geom g, int cp, int kr, int patch_bytes,
                int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = NT8 * 8;
  constexpr int WP = NT + 8;
  constexpr int MT = kRowsPerWarp;
  const int pw = kTile + g.k - 1;
  const int wrow_elems = kr * WP;
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* patch0 = smem_raw + (resident ? g.k : 1) * wrow_elems * 2;
  auto patch = [&](int i) {  // the two patch buffers
    return reinterpret_cast<__nv_bfloat16*>(patch0 + i * patch_bytes);
  };

  const int tid = threadIdx.x;
  const int o0 = blockIdx.y * NT;
  const int tiles_per_sample = g.tiles_x * g.tiles_y;
  const int n_tiles = g.n * tiles_per_sample;
  const int stride = gridDim.x;
  int tile = blockIdx.x;

  // Prologue, all threads: zero tails, resident weights, the first tile's patch.
  if (tid < 16) {
    patch(tid >> 3)[pw * pw * cp + (tid & 7)] = __float2bfloat16_rn(0.f);
  }
  if (resident) {
    pack_weights_bf16(wmat, wsm, 0, g.k, g.k, g.cin, cp, kr, g.cout, o0, NT, WP, tid,
                      kMmaThreads);
  }
  if (tile < n_tiles) {
    const int n = tile / tiles_per_sample;
    const int rem = tile % tiles_per_sample;
    fill_patch_bf16(ld, patch(0), n, (rem / g.tiles_x) * kTile, (rem % g.tiles_x) * kTile, pw,
                    g.cin, cp, tid, kMmaThreads);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  // ldmatrix.x4 lane -> (row of the 16-row operand, 8-element column half).
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lk = (lane >> 4) * 8;

  int cur = 0;
  for (; tile < n_tiles; tile += stride, cur ^= 1) {
    if (tid >= kConsumers) {
      // Producers: the next tile's patch into the other buffer.
      const int next = tile + stride;
      if (next < n_tiles) {
        const int n = next / tiles_per_sample;
        const int rem = next % tiles_per_sample;
        fill_patch_bf16(ld, patch(cur ^ 1), n, (rem / g.tiles_x) * kTile,
                        (rem % g.tiles_x) * kTile, pw, g.cin, cp, tid - kConsumers, kProducers);
      }
    } else {
      // Consumers: warp owns tile rows MT*warp .. MT*warp + MT - 1 (16 pixels each).
      float acc[MT][NT8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

      const uint32_t a_row = pw * cp * 2;  // bytes per patch row
      const uint32_t a_base = smem_u32(patch(cur)) + (((MT * warp) * pw + lrow) * cp + lk) * 2;
      const uint32_t b_base = smem_u32(wsm) + (lrow * WP + lk) * 2;
      const int ksteps = kr / 16;
      if (resident) {
        mma_rows<MT, NT8>(acc, a_base, a_row, b_base, 16 * WP * 2, g.k, ksteps);
      } else {
        for (int ky = 0; ky < g.k; ++ky) {
          // One ky row at a time: wait until the previous row is consumed, stage.
          asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
          pack_weights_bf16(wmat, wsm, ky, 1, g.k, g.cin, cp, kr, g.cout, o0, NT, WP, tid,
                            kConsumers);
          asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
          mma_rows<MT, NT8>(acc, a_base + ky * a_row, a_row, b_base, 16 * WP * 2, 1, ksteps);
        }
      }

      // Epilogue: round to bf16 and store.
      const int n = tile / tiles_per_sample;
      const int rem = tile % tiles_per_sample;
      int rows[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) rows[mt] = MT * warp + mt;
      store_tile_bf16<MT, NT8>(acc, rows, out, g, n, (rem / g.tiles_x) * kTile,
                               (rem % g.tiles_x) * kTile, o0, lane);
    }
    __syncthreads();  // patch(cur) consumed, patch(cur ^ 1) staged
  }
}

// ------------------------------------------------- bf16 kernel, wgmma ----
// The main-path kernel (64-channel tiles whose packed weights fit): the persistent
// kernel above with the product on wgmma.mma_async.m64n64k16 — A from registers (the
// same ldmatrix fragments of the sliding view: its 48-byte row pitch is nothing a
// shared-memory matrix descriptor can express), B through a descriptor, read once per
// warpgroup. The packed weights take wgmma's canonical K-major layout without swizzle:
// per 16-deep step 8 channel groups x 2 k-halves of 8 x 8 core matrices (8 rows of 16
// bytes, contiguous): 2,048 bytes a step and no row pad (the ICN stem: 157,696 B).
//
// Two warpgroups; warp w of warpgroup wg owns the adjacent tile rows y = 8 wg + 2 w
// (in the warpgroup's first m64-tile) and y + 1 (in its second). The fragment of patch
// row y + r at step ks is row y's operand for ky = r and row y + 1's for ky = r - 1,
// so a step loads k + 1 fragments for its 2 k wgmma (2 k with one load per product).
// The kernel size K is a template parameter: the 2 K wgmma of a step must stand in
// straight-line code between their fence and their commit (a branch there makes the
// compiler fence every product), and the K + 1 fragments must be registers. It is
// instantiated for K = 7, the stems; mma_plan() sends other sizes to mma.sync.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32);
}

// d (64 x 64, f32, this warp's 16 rows as 8 n8-tiles) += a (this warp's 16 x 16 bf16
// fragment) * b (16 x 64 bf16 behind desc_b).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

constexpr int kWgmmaStepBytes = 2048;  // packed weights of one 16-deep step, 64 channels

template <typename Loader, int K>
__global__ void __launch_bounds__(kMmaThreads, 1)
conv_wgmma_kernel(Loader ld, const __nv_bfloat16* __restrict__ wmat,
                  __nv_bfloat16* __restrict__ out, Geom g, int cp, int kr, int patch_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = 64;
  const int pw = kTile + K - 1;
  const int ksteps = kr / 16;
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* patch0 = smem_raw + K * ksteps * kWgmmaStepBytes;
  auto patch = [&](int i) {  // the two patch buffers
    return reinterpret_cast<__nv_bfloat16*>(patch0 + i * patch_bytes);
  };

  const int tid = threadIdx.x;
  const int o0 = blockIdx.y * NT;
  const int tiles_per_sample = g.tiles_x * g.tiles_y;
  const int n_tiles = g.n * tiles_per_sample;
  const int stride = gridDim.x;
  int tile = blockIdx.x;

  // Prologue, all threads: zero tails, the weights, the first tile's patch.
  if (tid < 16) {
    patch(tid >> 3)[pw * pw * cp + (tid & 7)] = __float2bfloat16_rn(0.f);
  }
  // Element (row r = ky * kr + kx * cp + c, channel o) of the packed matrix goes to
  // step r / 16, channel group o / 8, k-half (r / 8) % 2, row o % 8, column r % 8;
  // zero where kx >= k, c >= cin or o0 + o >= cout.
  const bool vec_w = (g.cout & 7) == 0 && (reinterpret_cast<uintptr_t>(wmat) & 15) == 0;
  for (int idx = tid; idx < K * kr * (NT / 8); idx += kMmaThreads) {
    const int og = idx % (NT / 8);
    const int r = idx / (NT / 8);
    const int j = r % kr;
    const int kx = j / cp;
    const int c = j % cp;
    const int o = o0 + og * 8;
    const bool real = kx < K && c < g.cin;
    const __nv_bfloat16* src =
        wmat + (static_cast<size_t>((r / kr) * K + kx) * g.cin + c) * g.cout + o;
    alignas(16) __nv_bfloat16 v[8];
    if (real && vec_w && o < g.cout) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (real && o + e < g.cout) ? src[e] : __float2bfloat16_rn(0.f);
      }
    }
    __nv_bfloat16* dst = wsm + (r >> 4) * (kWgmmaStepBytes / 2) + og * 128 +
                         ((r >> 3) & 1) * 64 + (r & 7);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e * 8] = v[e];
  }
  if (tile < n_tiles) {
    const int n = tile / tiles_per_sample;
    const int rem = tile % tiles_per_sample;
    fill_patch_bf16(ld, patch(0), n, (rem / g.tiles_x) * kTile, (rem % g.tiles_x) * kTile, pw,
                    g.cin, cp, tid, kMmaThreads);
  }
  // The weights were written through the generic proxy; wgmma reads them through the
  // async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lk = (lane >> 4) * 8;
  int rows[2];
  rows[0] = 8 * (warp >> 2) + 2 * (warp & 3);
  rows[1] = rows[0] + 1;
  // K-major core matrices: 128 bytes to the next k-half, 256 to the next channel group.
  const uint64_t desc0 = wgmma_desc(smem_u32(wsm), 128, 256);

  int cur = 0;
  for (; tile < n_tiles; tile += stride, cur ^= 1) {
    if (tid >= kConsumers) {
      // Producers: the next tile's patch into the other buffer.
      const int next = tile + stride;
      if (next < n_tiles) {
        const int n = next / tiles_per_sample;
        const int rem = next % tiles_per_sample;
        fill_patch_bf16(ld, patch(cur ^ 1), n, (rem / g.tiles_x) * kTile,
                        (rem % g.tiles_x) * kTile, pw, g.cin, cp, tid - kConsumers, kProducers);
      }
    } else {
      float acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

      const uint32_t a_row = pw * cp * 2;  // bytes per patch row
      const uint32_t a_base = smem_u32(patch(cur)) + ((rows[0] * pw + lrow) * cp + lk) * 2;
      auto load = [&](uint32_t (&f)[K + 1][4], int ks) {
#pragma unroll
        for (int r = 0; r <= K; ++r) ldmatrix_x4(f[r], a_base + r * a_row + ks * 32);
      };
      auto multiply = [&](const uint32_t (&f)[K + 1][4], int ks) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int r = 0; r <= K; ++r) {
          if (r < K) {
            wgmma_m64n64k16(acc[0], f[r], desc0 + static_cast<uint64_t>(r * ksteps + ks) * 128);
          }
          if (r > 0) {
            wgmma_m64n64k16(acc[1], f[r],
                            desc0 + static_cast<uint64_t>((r - 1) * ksteps + ks) * 128);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      };
      // Two fragment sets: a step's products run while the next step's fragments load;
      // wait_group 1 says the step before has retired, so its set may be overwritten.
      uint32_t f0[K + 1][4], f1[K + 1][4];
      load(f0, 0);
      for (int ks = 0; ks < ksteps; ks += 2) {
        multiply(f0, ks);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (ks + 1 < ksteps) {
          load(f1, ks + 1);
          multiply(f1, ks + 1);
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        }
        if (ks + 2 < ksteps) load(f0, ks + 2);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

      const int n = tile / tiles_per_sample;
      const int rem = tile % tiles_per_sample;
      store_tile_bf16<2, 8>(acc, rows, out, g, n, (rem / g.tiles_x) * kTile,
                            (rem % g.tiles_x) * kTile, o0, lane);
    }
    __syncthreads();  // patch(cur) consumed, patch(cur ^ 1) staged
  }
}

// bf16 launch: the wgmma kernel where the plan says so, else the mma.sync kernel.
template <typename Loader>
int launch_bf16(const Loader& ld, const void* wmat, void* out, const Geom& g,
                cudaStream_t stream) {
  const MmaPlan p = mma_plan(g.cin, g.k, g.cout);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_otiles = (g.cout + p.nt - 1) / p.nt;
  const long long n_tiles = static_cast<long long>(g.n) * g.tiles_x * g.tiles_y;
  long long workers = sms / n_otiles;
  if (workers < 1) workers = 1;
  if (workers > n_tiles) workers = n_tiles;
  const dim3 grid(static_cast<unsigned>(workers), n_otiles);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wmat);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (p.wgmma) {
    auto kernel = conv_wgmma_kernel<Loader, kWgmmaK>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kMmaThreads, p.smem, stream>>>(ld, w, o, g, p.cp, p.kr, p.patch_bytes);
  } else {
    auto kernel = p.nt == 64 ? conv_mma_kernel<Loader, 8> : conv_mma_kernel<Loader, 2>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kMmaThreads, p.smem, stream>>>(ld, w, o, g, p.cp, p.kr, p.patch_bytes,
                                                  p.resident);
  }
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------- float32 kernel ----
constexpr int kFmaThreads = 128;

// A block covers NT output channels; a thread owns CH of them for PX = 2 * NT / CH
// pixels of one tile column. A warp's lanes are 32 * CH / NT columns x NT / CH
// channel groups, so activation loads hit distinct banks (odd pixel pitch) and each
// weight float4 is a broadcast within its group.
template <typename Loader, int NT, int CH>
__global__ void __launch_bounds__(kFmaThreads, 2)
conv_fma_kernel(Loader ld, const float* __restrict__ wmat, float* __restrict__ out, Geom g,
                int n_otiles, int pitch, int patch_floats) {
  extern __shared__ __align__(16) float smem_f[];
  constexpr int GROUPS = NT / CH;   // channel groups across a warp's lanes
  constexpr int XL = 32 / GROUPS;   // tile columns a warp covers
  constexpr int PX = 2 * GROUPS;    // tile rows (pixels) a thread owns
  const int pw = kTile + g.k - 1;
  float* patch = smem_f;
  float* wring = smem_f + patch_floats;

  const int tid = threadIdx.x;
  const int n = blockIdx.z / n_otiles;
  const int o0 = (blockIdx.z % n_otiles) * NT;
  const int ox0 = blockIdx.x * kTile, oy0 = blockIdx.y * kTile;

  // Weight tap s = ky * k + kx: wring[s % stages][ci * NT + o] = w[ky, kx, ci, o0 + o],
  // 0 past O. Every call commits one cp.async group (an empty one past the end).
  const int tap_elems = g.cin * NT;
  const int n_taps = g.k * g.k;
  // Four output channels a copy where O is a multiple of 4 and the matrix aligned.
  const bool vec_w = (g.cout & 3) == 0 && (reinterpret_cast<uintptr_t>(wmat) & 15) == 0;
  auto stage_tap = [&](int sl) {
    if (sl < n_taps) {
      const float* wsrc = wmat + static_cast<size_t>(sl) * g.cin * g.cout + o0;
      float* dst = wring + (sl % kFmaStages) * tap_elems;
      if (vec_w) {
        for (int idx = tid * 4; idx < tap_elems; idx += kFmaThreads * 4) {
          const int o = idx % NT;
          const bool valid = o0 + o < g.cout;
          cp_async16(dst + idx, valid ? wsrc + static_cast<size_t>(idx / NT) * g.cout + o : wmat,
                     valid);
        }
      } else {
        for (int idx = tid; idx < tap_elems; idx += kFmaThreads) {
          const int o = idx % NT;
          const bool valid = o0 + o < g.cout;
          cp_async4(dst + idx, valid ? wsrc + static_cast<size_t>(idx / NT) * g.cout + o : wmat,
                    valid);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // The patch travels in the first group, with tap 0.
  const int npix = pw * pw;
  for (int p = tid; p < npix; p += kFmaThreads) {
    const auto px = ld.pixel(n, oy0 + p / pw, ox0 + p % pw);
    for (int c = 0; c < g.cin; ++c) cp_async4(patch + p * pitch + c, ld.at(px, c));
  }
#pragma unroll
  for (int sl = 0; sl < kFmaStages - 1; ++sl) stage_tap(sl);

  const int warp = tid >> 5, lane = tid & 31;
  const int x = (warp % (kTile / XL)) * XL + lane % XL;
  const int y0 = (warp / (kTile / XL)) * PX;
  const int grp = lane / XL;
  float acc[PX][CH];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int o = 0; o < CH; ++o) acc[j][o] = 0.f;

  int ky = 0, kx = 0;
  for (int sl = 0; sl < n_taps; ++sl) {
    // Tap sl has landed (all but the newest stages - 2 groups are complete), for
    // every thread after the barrier, which also frees the buffer of tap sl - 1.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFmaStages - 2) : "memory");
    __syncthreads();
    stage_tap(sl + kFmaStages - 1);
    const float* a_ptr = patch + ((y0 + ky) * pw + x + kx) * pitch;
    const float* w_ptr = wring + (sl % kFmaStages) * tap_elems + grp * CH;
    if (++kx == g.k) kx = 0, ++ky;
#pragma unroll 4
    for (int ci = 0; ci < g.cin; ++ci) {
      float a[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) a[j] = a_ptr[j * pw * pitch + ci];
      const float4* w4 = reinterpret_cast<const float4*>(w_ptr + ci * NT);
#pragma unroll
      for (int q = 0; q < CH / 4; ++q) {
        const float4 wv = w4[q];
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          acc[j][4 * q + 0] = fmaf(a[j], wv.x, acc[j][4 * q + 0]);
          acc[j][4 * q + 1] = fmaf(a[j], wv.y, acc[j][4 * q + 1]);
          acc[j][4 * q + 2] = fmaf(a[j], wv.z, acc[j][4 * q + 2]);
          acc[j][4 * q + 3] = fmaf(a[j], wv.w, acc[j][4 * q + 3]);
        }
      }
    }
  }

  const int ox = ox0 + x;
  const int ob = o0 + grp * CH;
  if (ox >= g.w_out) return;
  const bool vec = (g.cout & 3) == 0 && ob + CH <= g.cout;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int oy = oy0 + y0 + j;
    if (oy >= g.h_out) continue;
    float* dst = out + ((static_cast<size_t>(n) * g.h_out + oy) * g.w_out + ox) * g.cout + ob;
    if (vec) {
#pragma unroll
      for (int q = 0; q < CH / 4; ++q) {
        reinterpret_cast<float4*>(dst)[q] = make_float4(acc[j][4 * q], acc[j][4 * q + 1],
                                                        acc[j][4 * q + 2], acc[j][4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int o = 0; o < CH; ++o) {
        if (ob + o < g.cout) dst[o] = acc[j][o];
      }
    }
  }
}

template <typename Loader>
int launch_fma(const Loader& ld, const void* wmat, void* out, const Geom& g,
               cudaStream_t stream) {
  const FmaPlan p = fma_plan(g.cin, g.k, g.cout);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int n_otiles = (g.cout + p.nt - 1) / p.nt;
  auto kernel = p.nt == 64 ? conv_fma_kernel<Loader, 64, 16> : conv_fma_kernel<Loader, 16, 8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(g.tiles_x, g.tiles_y, g.n * n_otiles);
  kernel<<<grid, kFmaThreads, p.smem, stream>>>(ld, static_cast<const float*>(wmat),
                                                static_cast<float*>(out), g, n_otiles, p.pitch,
                                                p.patch_floats);
  return static_cast<int>(cudaGetLastError());
}

inline Geom make_geom(int n, int k, int cin, int cout, int h_out, int w_out) {
  Geom g;
  g.n = n, g.k = k, g.cin = cin, g.cout = cout, g.h_out = h_out, g.w_out = w_out;
  g.tiles_x = (w_out + kTile - 1) / kTile;
  g.tiles_y = (h_out + kTile - 1) / kTile;
  return g;
}

// Dynamic shared memory the launch will ask for (dtype 0 = float32, 1 = bfloat16).
inline int smem_bytes(int dtype, int cin, int k, int cout) {
  return dtype == 0 ? fma_plan(cin, k, cout).smem : mma_plan(cin, k, cout).smem;
}

}  // namespace fusg_conv
