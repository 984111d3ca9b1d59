"""Levenberg-Marquardt PnP ("CPC") with 4 canonical restarts, batched.

Counterpart of the JAX package's geometry/pnp.py (``lm_pnp_single`` :123,
``solve_pnp_4restarts`` :223). The JAX solver is a ``lax.while_loop`` with
data-dependent exits; here every solve of the (vehicles x 4 restarts) batch runs a
fixed ``_MAX_ITERS + 2`` iterations — the most the JAX loop can take (51 steps plus
one breaking iteration) — under a per-solve ``active`` mask that freezes its state
exactly where the JAX loop would stop. Nothing reads a value back to the host.

Stopping and damping policies are the reference's (utils/pnp_utils.py:8-40); the
Jacobian is ``torch.func.jacfwd`` of the projection residual, as the JAX package
uses ``jax.jacfwd``, behind the operator ``fusg::pnp_jacobian`` (:func:`pnp_jacobian`):
``torch.export`` (pipeline/aot.py) cannot trace a functorch transform, so an exported
scene holds the Jacobian as one node that runs this same ``jacfwd``.
"""
from __future__ import annotations

import threading
from typing import Tuple

import torch

from future_urban_scene_generation_tpu_torch.geometry.projection import project_normalized
from future_urban_scene_generation_tpu_torch.geometry.rotations import (
    matrix_to_rodrigues,
    rodrigues_to_matrix,
)

_EPS1 = 1e-8
_EPS2 = 1e-8
_MAX_ITERS = 50
_JTJ_COLLAPSE = 1e-7

# torch's forward-mode AD keeps its dual levels in one process-wide stack: two
# threads inside ``jacfwd`` at once (two camera streams, each on its worker) tear
# each other's level down. One Jacobian at a time, then.
_JACFWD_LOCK = threading.Lock()

CANONICAL_RVECS = (
    (1.1509305, -1.1552572, 1.2745042),
    (-0.12036987, 2.4503145, -2.0552557),
    (1.2133899, 1.1018114, -1.120625),
    (1.6997603, 0.19744678, -0.05384163),
)
CANONICAL_TVEC = (0.0, 0.0, 10.0)


def _residual(params, points3d, points2d, focals, centers):
    pred = project_normalized(points3d, params[..., :3], params[..., 3:], focals, centers)
    return (pred - points2d).reshape(pred.shape[:-2] + (-1,))


_JAC_FN = torch.func.vmap(torch.func.jacfwd(_residual), in_dims=(0, 0, 0, None, None))


@torch.library.custom_op("fusg::pnp_jacobian", mutates_args=())
def pnp_jacobian(params: torch.Tensor, points3d: torch.Tensor, points2d: torch.Tensor,
                 focals: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, 2N, 6) Jacobians of the B residuals at ``params`` (B, 6): ``jacfwd`` of
    :func:`_residual`, one solve a batch row. An operator, so that the transform runs
    eagerly inside it (also in a program restored by pipeline/aot.py). A dispatch
    mode's handler (``opcheck``'s checks, ``FlopCounterMode``) calls the kernel with
    functorch's dispatch keys excluded, where ``jacfwd`` fails: call it outside such
    modes."""
    with _JACFWD_LOCK:
        return _JAC_FN(params, points3d, points2d, focals, centers)


@pnp_jacobian.register_fake
def _pnp_jacobian_fake(params, points3d, points2d, focals, centers):
    # jacfwd stacks the six tangents last: the (B, 2N, 6) result is a (B, 6, 2N) block
    return params.new_empty((params.shape[0], 6, 2 * points2d.shape[1])).transpose(1, 2)


def _cholesky_solve_6(a_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD 6x6 systems ``a_mat @ x = b`` ((..., 6, 6), (..., 6)) by a
    fully unrolled Cholesky — the JAX package's hand-written solver, op for op.
    A non-SPD matrix yields NaNs, which the caller maps to the singular-solve
    break."""
    n = 6
    l_cols = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a_mat[..., j, j]
        for k in range(j):
            s = s - l_cols[j][k] * l_cols[j][k]
        diag = torch.sqrt(s)
        l_cols[j][j] = diag
        inv_diag = 1.0 / diag
        for i in range(j + 1, n):
            s = a_mat[..., i, j]
            for k in range(j):
                s = s - l_cols[i][k] * l_cols[j][k]
            l_cols[i][j] = s * inv_diag
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l_cols[i][k] * y[k]
        y[i] = s / l_cols[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l_cols[k][i] * x[k]
        x[i] = s / l_cols[i][i]
    return torch.stack(x, dim=-1)


def _matvec_t(jac, v):
    """J^T v for (B, m, 6) J and (B, m) v."""
    return torch.einsum("bmk,bm->bk", jac, v)


def lm_pnp_batch(points3d, points2d, init_rvec, init_tvec, focals, centers):
    """B independent LM solves. points3d (B, N, 3), points2d (B, N, 2), init
    rvec/tvec (B, 3), focals/centers (2,). Returns (rvec, tvec, mse) batched."""
    points3d = points3d.to(torch.float32)
    points2d = points2d.to(torch.float32)
    b = points3d.shape[0]
    n2 = points2d.shape[1] * 2
    dev = points3d.device

    def err_fn(params):
        return _residual(params, points3d, points2d, focals, centers)

    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    params = torch.cat([init_rvec, init_tvec], dim=-1).to(torch.float32)
    lam = torch.zeros(b, device=dev)
    factor = torch.full((b,), 2.0, device=dev)
    prev_err = torch.zeros(b, n2, device=dev)
    cur_err = torch.zeros(b, n2, device=dev)
    jac = torch.zeros(b, n2, 6, device=dev)
    updates = torch.zeros(b, 6, device=dev)
    final_err = torch.zeros(b, n2, device=dev)
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    has_prev = torch.zeros(b, dtype=torch.bool, device=dev)
    has_cur = torch.zeros(b, dtype=torch.bool, device=dev)

    def sel(mask, new, old):
        return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)

    for _ in range(_MAX_ITERS + 2):
        # cond_fn of the JAX while_loop, per solve.
        first = ~has_cur
        g = _matvec_t(jac, cur_err)
        stop_g = torch.amax(torch.abs(g), dim=-1) < _EPS1
        step_thresh = _EPS2 * (torch.linalg.vector_norm(params - updates, dim=-1) + _EPS2)
        stop_step = torch.linalg.vector_norm(updates, dim=-1) < step_thresh
        stop_iters = it > _MAX_ITERS
        keep = ~(stop_g | stop_step | stop_iters)
        active = ~done & (first | keep)

        # body_fn, computed for every solve and committed only where active.
        err = err_fn(params)
        jac_new = pnp_jacobian(params, points3d, points2d, focals, centers)
        jtj = torch.einsum("bmi,bmj->bij", jac_new, jac_new)
        collapse = torch.sum(jtj, dim=(-1, -2)) < _JTJ_COLLAPSE
        lam_b = torch.where(
            it == 0, 1e-8 * torch.amax(torch.diagonal(jtj, dim1=-2, dim2=-1), dim=-1), lam
        )
        a_mat = jtj + lam_b[:, None, None] * eye6
        upd = -_cholesky_solve_6(a_mat, _matvec_t(jac_new, err))
        solve_bad = ~torch.all(torch.isfinite(upd), dim=-1)
        broke = collapse | solve_bad
        step = ~broke

        new_params = sel(step, params + upd, params)
        new_prev = sel(step, cur_err, prev_err)
        new_cur = sel(step, err, cur_err)
        new_has_prev = torch.where(step, has_cur, has_prev)
        new_has_cur = has_cur | step
        new_it = it + step.to(torch.int32)

        f_prev = 0.5 * torch.sum(new_prev * new_prev, dim=-1)
        f_cur = 0.5 * torch.sum(new_cur * new_cur, dim=-1)
        denom = 0.5 * torch.sum(
            upd * (lam_b[:, None] * upd - _matvec_t(jac_new, new_cur)), dim=-1
        )
        gain = (f_prev - f_cur) / denom
        grow = gain <= 0.0
        lam_next = torch.where(
            grow,
            lam_b * factor,
            lam_b * torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=1.0 / 3.0),
        )
        factor_next = torch.where(grow, factor * 2.0, torch.full_like(factor, 2.0))
        apply_pol = step & new_has_prev
        new_lam = torch.where(apply_pol, lam_next, lam_b)
        new_factor = torch.where(apply_pol, factor_next, factor)

        params = sel(active, new_params, params)
        lam = sel(active, new_lam, lam)
        factor = sel(active, new_factor, factor)
        prev_err = sel(active, new_prev, prev_err)
        cur_err = sel(active, new_cur, cur_err)
        jac = sel(active, jac_new, jac)
        updates = sel(active, sel(step, upd, updates), updates)
        final_err = sel(active, err, final_err)
        it = sel(active, new_it, it)
        done = sel(active, broke, done)
        has_prev = sel(active, new_has_prev, has_prev)
        has_cur = sel(active, new_has_cur, has_cur)

    mse = torch.mean(final_err ** 2, dim=-1)
    return params[:, :3], params[:, 3:], mse


def solve_pnp_4restarts(points3d, points2d, focals, centers
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full CPC solve for V vehicles: 4 canonical restarts each, best-error
    selection, z-sign fix (utils/pnp_utils.py:43-130).

    points3d (V, N, 3), points2d (V, N, 2). Returns (mse (V,), rvec (V, 3),
    tvec (V, 3))."""
    v = points3d.shape[0]
    dev = points3d.device
    rv0 = torch.tensor(CANONICAL_RVECS, dtype=torch.float32, device=dev)
    tv0 = torch.tensor(CANONICAL_TVEC, dtype=torch.float32, device=dev)
    rvecs, tvecs, errors = lm_pnp_batch(
        points3d.repeat_interleave(4, dim=0),
        points2d.repeat_interleave(4, dim=0),
        rv0.repeat(v, 1),
        tv0.expand(4 * v, 3),
        focals,
        centers,
    )
    rvecs = rvecs.reshape(v, 4, 3)
    tvecs = tvecs.reshape(v, 4, 3)
    errors = errors.reshape(v, 4)
    best = torch.argmin(errors, dim=-1)
    ar = torch.arange(v, device=dev)
    rvec = rvecs[ar, best]
    tvec = tvecs[ar, best]

    sign = torch.where(tvec[:, 2] >= 0.0, 1.0, -1.0)
    r_mat = rodrigues_to_matrix(rvec)
    row_sign = torch.stack([sign, sign, torch.ones_like(sign)], dim=-1)
    r_mat = r_mat * row_sign[:, :, None]
    rvec = matrix_to_rodrigues(r_mat)
    tvec = tvec * sign[:, None]
    return errors[ar, best], rvec, tvec
