// P1: the whole CPC pose solve of V vehicles (geometry/pnp.py solve_pnp_4restarts) in
// one launch: 4 canonical restarts of Levenberg-Marquardt PnP a vehicle, the best
// restart by reprojection error, the z-sign fix.
//
// Not a port of a TPU kernel: the JAX package solves PnP in XLA (geometry/pnp.py
// lm_pnp_single, a lax.while_loop, no Pallas). The port's plain version
// (geometry/pnp.py lm_pnp_batch) runs the masked loop as eager torch, about 400
// launches an iteration and 52 iterations a scene: some 21,000 launches, all paced
// by the host, for well under a millisecond of the card's arithmetic.
//
// Bound: 4V solves x 52 iterations x (a 2N x 6 Jacobian by forward-mode derivatives, the
// 21 entries of J^T J, J^T r, a 6 x 6 Cholesky): a few MFLOP at V = 16, nanoseconds of
// the card. What is left is latency: one launch, and 52 dependent iterations each of
// a Jacobian, warp reductions and a serial 6 x 6 solve.
//
// Design: one block of 4 warps a vehicle, one warp a restart, the solve's state in
// registers, no sync with the host.
//
// The result equals the plain version's on the card bit for bit. That is not a
// nicety: on keypoints that fit no pose well (the benchmark's random-weight
// perception), many restarts never converge within the loop, and their paths are
// chaotic: a rounding difference in one operation moves the final pose by metres
// (the plain version on the CPU and on the card differ so), and with it the restart
// that wins. So every operation repeats what the plain version's eager kernels do on
// the card, in the same order, rounded the same way:
//   - elementwise operations, each rounded on its own: __f*_rn intrinsics, never
//     contracted into FMAs, and torch's forward-mode derivative formulas (jacfwd) op
//     for op, through rodrigues_to_matrix with its clamp of theta at 1e-12 and its
//     first-order branch below 1e-8, then project_normalized;
//   - the (N, 3) x (3, 3) products and J^T J: cuBLAS's in-order FMA chains over k;
//   - J^T r (a batched matrix-vector product): cuBLAS's split of the 2N rows into 8
//     blocks, an FMA chain in each, then a shuffle-down tree over the 8 partials;
//   - sums and 2-norms along a row: ATen's inner reduction (Reduce.cuh): lane t of
//     last_pow2(n) lanes adds elements t, t + w, ... into 4 accumulators, then a
//     shuffle-down tree;
//   - sin, cos, acos and sqrt: the same CUDA functions ATen calls.
// Each lane evaluates its rows (the 2N residual rows strided over the lanes) into
// shared memory; then every lane computes the solve's reductions, the damped 6 x 6
// Cholesky of _cholesky_solve_6 and the policy from there, redundantly, so all lanes
// hold the same bits. What the plain loop keeps per row is read only through J^T
// cur_err (the next iteration's gradient: the J^T r of the committed step) and the
// half sums of squares of the previous and current residuals, so the warp carries
// those. The loop is lm_pnp_batch's: the fixed _MAX_ITERS + 2 iterations, each
// committed only where the solve is active. A solve that is inactive stays inactive
// (its state, and so its test, no longer changes), so its warp leaves the loop then:
// the commits are those of the masked loop. Thread 0 then picks the first restart of
// least mse (torch.argmin's rule: a NaN is least) and applies the z-sign row flip and
// matrix_to_rodrigues.
//
// The orders of the two cuBLAS products and of ATen's reduction were read off the
// card (torch 2.11, CUDA 12.8, H100) at the scene's sizes (N = 12 keypoints, 4V = 16
// and 64 solves); at another N the kernel keeps the same orders, which cuBLAS may not.

#include "fusg_kernels.h"

#include <math.h>

namespace {

constexpr int kRestarts = 4;
constexpr int kThreads = 32 * kRestarts;
constexpr int kMaxIters = 50;  // geometry/pnp.py _MAX_ITERS
constexpr int kLoopIters = kMaxIters + 2;
constexpr int kGemvLanes = 8;  // cuBLAS's split of J^T r's rows
constexpr int kPnpMaxPoints = 128;  // keypoints a vehicle: 28 KB of rows in shared memory
constexpr unsigned kFull = 0xffffffffu;

// geometry/pnp.py's constants as torch casts them (decimal -> double -> float).
__constant__ float kCanonicalRvecs[kRestarts][3] = {
    {static_cast<float>(1.1509305), static_cast<float>(-1.1552572),
     static_cast<float>(1.2745042)},
    {static_cast<float>(-0.12036987), static_cast<float>(2.4503145),
     static_cast<float>(-2.0552557)},
    {static_cast<float>(1.2133899), static_cast<float>(1.1018114),
     static_cast<float>(-1.120625)},
    {static_cast<float>(1.6997603), static_cast<float>(0.19744678),
     static_cast<float>(-0.05384163)},
};
constexpr float kCanonicalTz = 10.0f;
constexpr float kEps1 = static_cast<float>(1e-8);
constexpr float kEps2 = static_cast<float>(1e-8);
constexpr float kJtjCollapse = static_cast<float>(1e-7);
constexpr float kLambda0 = static_cast<float>(1e-8);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kThetaClamp = static_cast<float>(1e-12);  // rotations.py _EPS
constexpr float kFirstOrder = static_cast<float>(1e-8);
constexpr float kPi = static_cast<float>(3.141592653589793);

// One rounding an operation, as the plain version's eager kernels do.
__device__ __forceinline__ float f_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float f_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float f_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float f_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float f_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__host__ __device__ constexpr int last_pow2(int n) { return n < 2 ? 1 : 2 * last_pow2(n / 2); }

// ATen's inner sum of N values (N < 128; Reduce.cuh with block width w = last_pow2(N)):
// lane t adds elements t, t + w, t + 2w, t + 3w into four accumulators and combines them
// in order; a shuffle-down tree over the w lanes follows. Every lane here plays all w.
template <int N>
__device__ __forceinline__ float aten_sum(const float* x) {
  constexpr int w = last_pow2(N) < 32 ? last_pow2(N) : 32;
  static_assert(N < 4 * w, "one pass of four accumulators");
  float lane[w];
#pragma unroll
  for (int t = 0; t < w; ++t) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = f_add(acc, t + i * w < N ? f_add(0.f, x[t + i * w]) : 0.f);
    lane[t] = acc;
  }
#pragma unroll
  for (int off = w / 2; off > 0; off /= 2) {
#pragma unroll
    for (int t = 0; t < off; ++t) lane[t] = f_add(lane[t], lane[t + off]);
  }
  return lane[0];
}

// The same reduction of the squares of n values in shared memory (each square rounded, as
// the plain version's separate product), n known at run time, one lane a lane of ATen's;
// every lane gets the sum.
__device__ __forceinline__ float aten_sum_squares_warp(const float* x, int n, int lane) {
  int w = 1;
  while (2 * w <= n && w < 32) w *= 2;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < w) {
    int idx = lane;
    for (; idx + 3 * w < n; idx += 4 * w) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = x[idx + i * w];
        acc[i] = f_add(acc[i], f_mul(v, v));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (idx + i * w < n) {
        const float v = x[idx + i * w];
        acc[i] = f_add(acc[i], f_mul(v, v));
      }
    }
  }
  float v = f_add(f_add(f_add(acc[0], acc[1]), acc[2]), acc[3]);
  for (int off = w / 2; off > 0; off /= 2) v = f_add(v, __shfl_down_sync(kFull, v, off));
  return __shfl_sync(kFull, v, 0);
}

// torch.linalg.vector_norm of N values: ATen's reduction of their squares.
template <int N>
__device__ __forceinline__ float aten_norm(const float* x) {
  float sq[N];
#pragma unroll
  for (int i = 0; i < N; ++i) sq[i] = f_mul(x[i], x[i]);
  return __fsqrt_rn(aten_sum<N>(sq));
}

// NaN-propagating max (torch.amax).
template <int N>
__device__ __forceinline__ float amax(const float* x) {
  float m = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) m = (isnan(m) || m >= x[i]) ? m : x[i];
  return m;
}

// One row of cuBLAS's (.., 3) x (3, 3) product: an in-order FMA chain.
__device__ __forceinline__ float dot3(const float p[3], const float r[3]) {
  return f_fma(p[2], r[2], f_fma(p[1], r[1], f_mul(p[0], r[0])));
}

__device__ __forceinline__ void skew(const float v[3], float out[3][3]) {
  out[0][0] = 0.f;   out[0][1] = -v[2];  out[0][2] = v[1];
  out[1][0] = v[2];  out[1][1] = 0.f;    out[1][2] = -v[0];
  out[2][0] = -v[1]; out[2][1] = v[0];   out[2][2] = 0.f;
}

// rotations.py rodrigues_to_matrix (R = I cos t + (1 - cos t) u u^T + [u]_x sin t, u =
// r / max(t, 1e-12); I + [r]_x where t < 1e-8) and, with `tangents`, its forward-mode
// derivatives dr[k] along r_k, by torch's formulas: d(a b) = db a + da b, d(a / b) =
// (da - db (a / b)) / b, d cos = dt (-sin), d sin = dt cos, d |r| = r_k / |r|.
__device__ void rodrigues(const float rv[3], float r[3][3], float dr[3][3][3], bool tangents) {
  const float theta = aten_norm<3>(rv);
  if (theta < kFirstOrder) {
    float k[3][3];
    skew(rv, k);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) r[i][j] = f_add(i == j ? 1.f : 0.f, k[i][j]);
    }
    if (tangents) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float e[3] = {d == 0 ? 1.f : 0.f, d == 1 ? 1.f : 0.f, d == 2 ? 1.f : 0.f};
        skew(e, dr[d]);
      }
    }
    return;
  }
  const float safe = clamp_min(theta, kThetaClamp);
  float u[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) u[i] = f_div(rv[i], safe);
  const float c = cosf(theta), s = sinf(theta);
  const float t2 = f_sub(1.f, c);
  float uu[3][3], k[3][3];
  skew(u, k);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      uu[i][j] = f_mul(u[i], u[j]);
      r[i][j] = f_add(f_add(f_mul(i == j ? 1.f : 0.f, c), f_mul(t2, uu[i][j])), f_mul(k[i][j], s));
    }
  }
  if (!tangents) return;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float th_t = theta == 0.f ? 0.f : f_div(rv[d], theta);
    const float safe_t = theta >= kThetaClamp ? th_t : 0.f;
    float u_t[3], k_t[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) u_t[i] = f_div(f_sub(i == d ? 1.f : 0.f, f_mul(safe_t, u[i])), safe);
    skew(u_t, k_t);
    const float c_t = f_mul(th_t, -s), s_t = f_mul(th_t, c);
    const float t2_t = -c_t;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float uu_t = f_add(f_mul(u_t[j], u[i]), f_mul(u_t[i], u[j]));
        const float t3_t = f_add(f_mul(uu_t, t2), f_mul(t2_t, uu[i][j]));
        const float t4_t = f_add(f_mul(i == j ? 1.f : 0.f, c_t), t3_t);
        const float t5_t = f_add(f_mul(s_t, k[i][j]), f_mul(k_t[i][j], s));
        dr[d][i][j] = f_add(t4_t, t5_t);
      }
    }
  }
}

// rotations.py matrix_to_rodrigues (cv2.Rodrigues conventions), one matrix.
__device__ void matrix_to_rodrigues(const float m[3][3], float out[3]) {
  const float trace = f_add(f_add(m[0][0], m[1][1]), m[2][2]);
  float cos_t = f_mul(f_sub(trace, 1.f), 0.5f);
  cos_t = cos_t < -1.f ? -1.f : (cos_t > 1.f ? 1.f : cos_t);
  const float theta = acosf(cos_t);
  if (fabsf(theta) < static_cast<float>(1e-7)) {
    out[0] = out[1] = out[2] = 0.f;
    return;
  }
  if (!(fabsf(f_sub(theta, kPi)) < static_cast<float>(1e-5))) {
    const float axis[3] = {f_sub(m[2][1], m[1][2]), f_sub(m[0][2], m[2][0]),
                           f_sub(m[1][0], m[0][1])};
    const float denom = clamp_min(f_mul(2.f, sinf(theta)), kThetaClamp);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = f_mul(f_div(axis[i], denom), theta);
    return;
  }
  float u_abs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) u_abs[i] = __fsqrt_rn(clamp_min(f_mul(f_add(m[i][i], 1.f), 0.5f), 0.f));
  int k = 0;  // torch.argmax: the first maximum, a NaN counting as the maximum
  for (int i = 1; i < 3; ++i) {
    if (isnan(u_abs[k])) break;
    if (isnan(u_abs[i]) || u_abs[i] > u_abs[k]) k = i;
  }
  auto sign_of = [](float x) { return isnan(x) ? x : (x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f)); };
  const float s01 = sign_of(f_add(m[0][1], m[1][0]));
  const float s02 = sign_of(f_add(m[0][2], m[2][0]));
  const float s12 = sign_of(f_add(m[1][2], m[2][1]));
  const float by_k[3][3] = {{1.f, s01, s02}, {s01, 1.f, s12}, {s02, s12, 1.f}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float sg = by_k[k][i] == 0.f ? 1.f : by_k[k][i];
    out[i] = f_mul(f_mul(u_abs[i], sg), theta);
  }
}

// Residual row `row` (prediction - observation, x and y interleaved) and its
// derivatives along (rvec, tvec): project_normalized of one keypoint.
__device__ __forceinline__ float residual_row(const float r[3][3], const float dr[3][3][3],
                                              const float tv[3], const float* p3,
                                              const float* p2, int row, const float fc[2],
                                              const float cc[2], float jac[6]) {
  const int j = row >> 1;
  const bool y = row & 1;
  const float p[3] = {p3[3 * j], p3[3 * j + 1], p3[3 * j + 2]};
  const float f = y ? fc[1] : fc[0];
  const float cam = f_add(dot3(p, y ? r[1] : r[0]), y ? tv[1] : tv[0]);
  const float cam_z = f_add(dot3(p, r[2]), tv[2]);
  const float m = f_mul(f, cam);
  const float q = f_div(m, cam_z);
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    float cam_t, cam_z_t;
    if (d < 3) {
      cam_t = dot3(p, y ? dr[d][1] : dr[d][0]);
      cam_z_t = dot3(p, dr[d][2]);
    } else {
      cam_t = d - 3 == (y ? 1 : 0) ? 1.f : 0.f;
      cam_z_t = d == 5 ? 1.f : 0.f;
    }
    jac[d] = f_div(f_sub(f_mul(cam_t, f), f_mul(cam_z_t, q)), cam_z);
  }
  return f_sub(f_add(q, y ? cc[1] : cc[0]), p2[row]);
}

// geometry/pnp.py _cholesky_solve_6, operation for operation: a non-SPD matrix gives NaNs.
__device__ __forceinline__ void cholesky_solve_6(const float a[6][6], const float b[6],
                                                 float x[6]) {
  float l[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = f_sub(s, f_mul(l[j][k], l[j][k]));
    const float diag = __fsqrt_rn(s);
    l[j][j] = diag;
    const float inv_diag = f_div(1.f, diag);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = f_sub(t, f_mul(l[i][k], l[j][k]));
      l[i][j] = f_mul(t, inv_diag);
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = f_sub(s, f_mul(l[i][k], y[k]));
    y[i] = f_div(s, l[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = f_sub(s, f_mul(l[k][i], x[k]));
    x[i] = f_div(s, l[i][i]);
  }
}

__global__ void __launch_bounds__(kThreads)
pnp_cpc_kernel(const float* __restrict__ points3d, const float* __restrict__ points2d,
               const float* __restrict__ focals, const float* __restrict__ centers,
               float* __restrict__ mse_out, float* __restrict__ rvec_out,
               float* __restrict__ tvec_out, int n_points) {
  extern __shared__ float s_rows[];  // a warp's residuals (2N), then its Jacobian (2N x 6)
  __shared__ float s_mse[kRestarts];
  __shared__ float s_params[kRestarts][6];

  const int vehicle = blockIdx.x;
  const int restart = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_rows = 2 * n_points;
  float* s_err = s_rows + restart * 7 * n_rows;
  float* s_jac = s_err + n_rows;
  const float* p3 = points3d + static_cast<long long>(vehicle) * n_points * 3;
  const float* p2 = points2d + static_cast<long long>(vehicle) * n_points * 2;
  const float fc[2] = {focals[0], focals[1]};
  const float cc[2] = {centers[0], centers[1]};

  // A solve's state, the same in every lane of its warp (lm_pnp_batch's, with the
  // per-row tensors replaced by what the loop reads of them).
  float params[6] = {kCanonicalRvecs[restart][0], kCanonicalRvecs[restart][1],
                     kCanonicalRvecs[restart][2], 0.f, 0.f, kCanonicalTz};
  float lam = 0.f, factor = 2.f;
  float grad[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // jac^T cur_err
  float updates[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float f_prev = 0.f, f_cur = 0.f;  // 0.5 |prev_err|^2, 0.5 |cur_err|^2
  float final_sq = 0.f;             // |final_err|^2
  int it = 0;
  bool done = false, has_prev = false, has_cur = false;

  for (int iter = 0; iter < kLoopIters; ++iter) {
    // cond_fn of the JAX while_loop, per solve.
    const float g_abs[6] = {fabsf(grad[0]), fabsf(grad[1]), fabsf(grad[2]),
                            fabsf(grad[3]), fabsf(grad[4]), fabsf(grad[5])};
    const bool stop_g = amax<6>(g_abs) < kEps1;
    float diff[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) diff[k] = f_sub(params[k], updates[k]);
    const float step_thresh = f_mul(kEps2, f_add(aten_norm<6>(diff), kEps2));
    const bool stop_step = aten_norm<6>(updates) < step_thresh;
    const bool keep = !(stop_g || stop_step || it > kMaxIters);
    const bool active = !done && (!has_cur || keep);
    if (!active) break;  // nothing of the state changes any more: the test stays false

    // body_fn. The rows of the residual and the Jacobian, a row a lane.
    {
      float r[3][3], dr[3][3][3];
      rodrigues(params, r, dr, true);
      for (int row = lane; row < n_rows; row += 32) {
        float jac[6];
        s_err[row] = residual_row(r, dr, params + 3, p3, p2, row, fc, cc, jac);
#pragma unroll
        for (int k = 0; k < 6; ++k) s_jac[6 * row + k] = jac[k];
      }
    }
    __syncwarp();
    // J^T J: cuBLAS's FMA chain over the rows in order, each entry.
    float jtj[6][6];
    {
      const float* j0 = s_jac;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int k = 0; k <= i; ++k) jtj[i][k] = f_mul(j0[i], j0[k]);
      }
      for (int m = 1; m < n_rows; ++m) {
        const float* jm = s_jac + 6 * m;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int k = 0; k <= i; ++k) jtj[i][k] = f_fma(jm[i], jm[k], jtj[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int k = i + 1; k < 6; ++k) jtj[i][k] = jtj[k][i];
      }
    }
    // J^T r: cuBLAS's 8 blocks of rows, an FMA chain each, then a shuffle-down tree.
    float rhs[6];
    {
      const int blk = (n_rows + kGemvLanes - 1) / kGemvLanes;
      float part[kGemvLanes][6];
#pragma unroll
      for (int b = 0; b < kGemvLanes; ++b) {
#pragma unroll
        for (int k = 0; k < 6; ++k) part[b][k] = 0.f;
        const int m0 = b * blk, m1 = min(n_rows, m0 + blk);
        if (m0 < m1) {
#pragma unroll
          for (int k = 0; k < 6; ++k) part[b][k] = f_mul(s_jac[6 * m0 + k], s_err[m0]);
          for (int m = m0 + 1; m < m1; ++m) {
#pragma unroll
            for (int k = 0; k < 6; ++k) part[b][k] = f_fma(s_jac[6 * m + k], s_err[m], part[b][k]);
          }
        }
      }
#pragma unroll
      for (int off = kGemvLanes / 2; off > 0; off /= 2) {
#pragma unroll
        for (int b = 0; b < off; ++b) {
#pragma unroll
          for (int k = 0; k < 6; ++k) part[b][k] = f_add(part[b][k], part[b + off][k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) rhs[k] = part[0][k];
    }
    const float sse = aten_sum_squares_warp(s_err, n_rows, lane);  // |err|^2
    __syncwarp();  // every lane has read the rows before the next iteration writes them

    const bool collapse = aten_sum<36>(&jtj[0][0]) < kJtjCollapse;
    const float diag[6] = {jtj[0][0], jtj[1][1], jtj[2][2], jtj[3][3], jtj[4][4], jtj[5][5]};
    const float lam_b = it == 0 ? f_mul(kLambda0, amax<6>(diag)) : lam;
    float a_mat[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int k = 0; k < 6; ++k) a_mat[i][k] = f_add(jtj[i][k], f_mul(lam_b, i == k ? 1.f : 0.f));
    }
    float upd[6];
    cholesky_solve_6(a_mat, rhs, upd);
    bool solve_bad = false;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      upd[k] = -upd[k];
      solve_bad |= !isfinite(upd[k]);
    }
    const bool broke = collapse || solve_bad;
    const bool step = !broke;

    const float new_f_prev = step ? f_cur : f_prev;
    const float new_f_cur = step ? f_mul(0.5f, sse) : f_cur;
    const bool new_has_prev = step ? has_cur : has_prev;
    // 0.5 sum(upd (lam_b upd - J^T new_cur)), read only after a step, where new_cur is
    // this iteration's residual and J^T new_cur its J^T r.
    float terms[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) terms[k] = f_mul(upd[k], f_sub(f_mul(lam_b, upd[k]), rhs[k]));
    const float denom = f_mul(0.5f, aten_sum<6>(terms));
    const float gain = f_div(f_sub(new_f_prev, new_f_cur), denom);
    const bool grow = gain <= 0.f;
    const float base = f_sub(f_mul(2.f, gain), 1.f);
    const float lam_next = grow ? f_mul(lam_b, factor)
                                : f_mul(lam_b, clamp_min(f_sub(1.f, f_mul(f_mul(base, base), base)),
                                                         kThird));
    const float factor_next = grow ? f_mul(factor, 2.f) : 2.f;
    const bool apply_pol = step && new_has_prev;

    // The commit (the solve is active here).
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (step) {
        params[k] = f_add(params[k], upd[k]);
        updates[k] = upd[k];
      }
      grad[k] = rhs[k];  // after a break the solve is done and reads it no more
    }
    lam = apply_pol ? lam_next : lam_b;
    factor = apply_pol ? factor_next : factor;
    f_prev = new_f_prev;
    f_cur = new_f_cur;
    final_sq = sse;
    it += step ? 1 : 0;
    done = broke;
    has_prev = new_has_prev;
    has_cur = has_cur || step;
  }

  if (lane == 0) {  // torch.mean: the sum times 1 / 2N
    s_mse[restart] = f_mul(final_sq, f_div(1.f, static_cast<float>(n_rows)));
#pragma unroll
    for (int k = 0; k < 6; ++k) s_params[restart][k] = params[k];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  // torch.argmin over the restarts: the first least, a NaN counting as least.
  int best = 0;
  for (int r = 1; r < kRestarts; ++r) {
    if (isnan(s_mse[best])) break;
    if (isnan(s_mse[r]) || s_mse[r] < s_mse[best]) best = r;
  }
  const float bp[6] = {s_params[best][0], s_params[best][1], s_params[best][2],
                       s_params[best][3], s_params[best][4], s_params[best][5]};
  // The z-sign fix: a camera behind the object turns about its z axis.
  const float sign = bp[5] >= 0.f ? 1.f : -1.f;
  float r[3][3], dr[3][3][3];
  rodrigues(bp, r, dr, false);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) r[i][j] = f_mul(r[i][j], i < 2 ? sign : 1.f);
  }
  float rv[3];
  matrix_to_rodrigues(r, rv);
  mse_out[vehicle] = s_mse[best];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rvec_out[3 * vehicle + i] = rv[i];
    tvec_out[3 * vehicle + i] = f_mul(bp[3 + i], sign);
  }
}

}  // namespace

extern "C" int fusg_pnp_cpc(const float* points3d, const float* points2d, const float* focals,
                            const float* centers, float* mse, float* rvec, float* tvec,
                            int n_vehicles, int n_points, cudaStream_t stream) {
  if (n_vehicles < 0 || n_points < 1 || n_points > kPnpMaxPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_vehicles == 0) return 0;
  const int smem = kRestarts * 7 * 2 * n_points * static_cast<int>(sizeof(float));
  pnp_cpc_kernel<<<n_vehicles, kThreads, smem, stream>>>(points3d, points2d, focals, centers,
                                                         mse, rvec, tvec, n_points);
  return static_cast<int>(cudaGetLastError());
}
