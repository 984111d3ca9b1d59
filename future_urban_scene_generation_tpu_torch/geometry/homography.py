"""Homography estimation, batched: the normalized DLT with its analytic
Gauss-Newton polish, and the closed-form 4-point solve.

Counterpart of the JAX package's geometry/homography.py ``find_homography`` (:234,
``refine=False`` — the plane-warp path) and ``find_homography_quad`` (:188). Every
function but ``_sampson_refine`` (:110, cv2's post-DLT polish, one homography) takes
a leading batch dim. Solves use the ``_ex`` linear-algebra variants,
so no error check reads a value back to the host.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _normalize_points(pts):
    """Hartley normalization of (B, n, 2) points -> (normed, T (B, 3, 3))."""
    centroid = pts.mean(dim=1)
    d = torch.linalg.vector_norm(pts - centroid[:, None], dim=-1)
    mean_d = d.mean(dim=1)
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    t_mat = torch.stack(
        [
            torch.stack([s, zero, -s * centroid[:, 0]], -1),
            torch.stack([zero, s, -s * centroid[:, 1]], -1),
            torch.stack([zero, zero, one], -1),
        ],
        -2,
    )
    normed = (pts - centroid[:, None]) * s[:, None, None]
    return normed, t_mat


def _dlt(src_n, dst_n):
    """Null vector of the DLT system via the smallest eigenvector of A^T A.
    Non-finite systems (a failed upstream solve) get the identity, so the
    eigensolver never sees NaN; their homography is marked invalid later."""
    x, y = src_n[..., 0], src_n[..., 1]
    u, v = dst_n[..., 0], dst_n[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    row1 = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], -1)
    row2 = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y, -v], -1)
    a_mat = torch.cat([row1, row2], dim=1)  # (B, 2n, 9)
    ata = a_mat.transpose(-1, -2) @ a_mat
    finite = torch.isfinite(ata).all(dim=-1).all(dim=-1)
    eye9 = torch.eye(9, dtype=ata.dtype, device=ata.device)
    ata = torch.where(finite[:, None, None], ata, eye9)
    eigvals, eigvecs = torch.linalg.eigh(ata)
    h = eigvecs[..., :, 0]
    return h.reshape(-1, 3, 3), eigvals


def _gn_polish_normed(h, src_n, dst_n, iters: int = 2):
    """Analytic-Jacobian Gauss-Newton polish of the DLT null vector (B, 9) in the
    normalized frame, with the gauge fill tr * h h^T (homography.py:58-107)."""
    b, n = src_n.shape[0], src_n.shape[1]
    p = torch.cat([src_n, torch.ones_like(src_n[..., :1])], dim=-1)  # (B, n, 3)
    zeros = torch.zeros(b, n, 3, dtype=src_n.dtype, device=src_n.device)
    eye9 = torch.eye(9, dtype=src_n.dtype, device=src_n.device)
    for _ in range(iters):
        h_m = h.reshape(b, 3, 3)
        cp = torch.einsum("bnk,bk->bn", p, h_m[:, 2])
        cp = torch.where(torch.abs(cp) < 1e-12, torch.full_like(cp, 1e-12), cp)
        pred_x = torch.einsum("bnk,bk->bn", p, h_m[:, 0]) / cp
        pred_y = torch.einsum("bnk,bk->bn", p, h_m[:, 1]) / cp
        r = torch.cat([pred_x - dst_n[..., 0], pred_y - dst_n[..., 1]], dim=1)
        p_cp = p / cp[..., None]
        j_x = torch.cat([p_cp, zeros, -pred_x[..., None] * p_cp], dim=-1)
        j_y = torch.cat([zeros, p_cp, -pred_y[..., None] * p_cp], dim=-1)
        j = torch.cat([j_x, j_y], dim=1)  # (B, 2n, 9)
        jtj = j.transpose(-1, -2) @ j
        tr = torch.diagonal(jtj, dim1=-2, dim2=-1).sum(-1)
        m = (
            jtj
            + tr[:, None, None] * (h[:, :, None] * h[:, None, :])
            + (1e-7 * tr)[:, None, None] * eye9
        )
        chol, _ = torch.linalg.cholesky_ex(m)
        rhs = -torch.einsum("bmk,bm->bk", j, r)
        delta = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        cand = h + delta
        cand = cand / torch.clamp(torch.linalg.vector_norm(cand, dim=-1), min=1e-12)[:, None]
        ok = torch.isfinite(cand).all(dim=-1)
        h = torch.where(ok[:, None], cand, h)
    return h


def _finish(h_mat, valid):
    scale = h_mat[:, 2, 2]
    finite = torch.isfinite(h_mat).all(dim=-1).all(dim=-1) & (torch.abs(scale) > 1e-12)
    valid = valid & finite
    safe = torch.where(torch.abs(scale) > 1e-12, scale, torch.ones_like(scale))
    eye = torch.eye(3, dtype=h_mat.dtype, device=h_mat.device)
    h_out = torch.where(valid[:, None, None], h_mat / safe[:, None, None], eye)
    return h_out, valid


def find_homography(src: torch.Tensor, dst: torch.Tensor, refine: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H mapping src -> dst from (B, n, 2) correspondences, n >= 4. Returns (H (B, 3, 3)
    with H[2,2] = 1, valid (B,)). ``refine=False`` (the plane-warp path) polishes the
    DLT null vector in closed form; ``refine=True`` (the JAX default, the
    reference-parity ``render/planes``) runs :func:`_sampson_refine` on each
    denormalized H instead."""
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    src_n, t_src = _normalize_points(src)
    dst_n, t_dst = _normalize_points(dst)
    h_n, eigvals = _dlt(src_n, dst_n)
    if not refine:
        h_n = _gn_polish_normed(h_n.reshape(-1, 9), src_n, dst_n).reshape(-1, 3, 3)
    h_mat = torch.linalg.solve_ex(t_dst, h_n @ t_src).result
    if refine:
        h_mat = torch.stack([_sampson_refine(h, s, d) for h, s, d in zip(h_mat, src, dst)])
    rank_ok = eigvals[:, 1] > 1e-6 * torch.clamp(eigvals[:, -1], min=1e-12)
    return _finish(h_mat, rank_ok)


def _unit_square_to_quad(q):
    """Projective map from the unit square's corners to quad corners q (B, 4, 2)."""
    s = q[:, 0] - q[:, 1] + q[:, 2] - q[:, 3]
    d1 = q[:, 1] - q[:, 2]
    d2 = q[:, 3] - q[:, 2]
    den = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    den = torch.where(torch.abs(den) < 1e-20, torch.full_like(den, 1e-20), den)
    g = (s[:, 0] * d2[:, 1] - s[:, 1] * d2[:, 0]) / den
    h = (d1[:, 0] * s[:, 1] - d1[:, 1] * s[:, 0]) / den
    a = q[:, 1] - q[:, 0] + g[:, None] * q[:, 1]
    b = q[:, 3] - q[:, 0] + h[:, None] * q[:, 3]
    one = torch.ones_like(g)
    return torch.stack(
        [
            torch.stack([a[:, 0], b[:, 0], q[:, 0, 0]], -1),
            torch.stack([a[:, 1], b[:, 1], q[:, 0, 1]], -1),
            torch.stack([g, h, one], -1),
        ],
        -2,
    )


def _adj3(m):
    """Adjugate of (B, 3, 3) matrices."""
    def cof(i0, i1, j0, j1):
        return m[:, i0, j0] * m[:, i1, j1] - m[:, i0, j1] * m[:, i1, j0]

    return torch.stack(
        [
            torch.stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)], -1),
            torch.stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)], -1),
            torch.stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)], -1),
        ],
        -2,
    )


def _quad_nondegenerate(q, tol: float = 1e-4):
    crosses = []
    for i in range(4):
        e1 = q[:, (i + 1) % 4] - q[:, i]
        e2 = q[:, (i + 2) % 4] - q[:, i]
        crosses.append(torch.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]))
    return torch.stack(crosses, -1).amin(dim=-1) > tol


def find_homography_quad(src: torch.Tensor, dst: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form exact-interpolation homography for exactly 4 correspondences
    (B, 4, 2): H = S2Q(dst_n) @ adj(S2Q(src_n)) on normalized points."""
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    src_n, t_src = _normalize_points(src)
    dst_n, t_dst = _normalize_points(dst)
    h_n = _unit_square_to_quad(dst_n) @ _adj3(_unit_square_to_quad(src_n))
    s = t_dst[:, 0, 0]
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    inv_t_dst = torch.stack(
        [
            torch.stack([1.0 / s, zero, -t_dst[:, 0, 2] / s], -1),
            torch.stack([zero, 1.0 / s, -t_dst[:, 1, 2] / s], -1),
            torch.stack([zero, zero, one], -1),
        ],
        -2,
    )
    h_mat = inv_t_dst @ (h_n @ t_src)
    valid = _quad_nondegenerate(src_n) & _quad_nondegenerate(dst_n)
    return _finish(h_mat, valid)


def _sampson_refine(h_mat: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    iters: int = 10) -> torch.Tensor:
    """Gauss-Newton refinement of the transfer error of one (3, 3) homography on (n, 2)
    correspondences (JAX :110): ``iters`` steps of (J^T J + 1e-9 I) d = -J^T r, the
    Jacobian by ``torch.func.jacfwd``; a non-finite step is dropped."""
    from future_urban_scene_generation_tpu_torch.geometry.pnp import _JACFWD_LOCK

    src_h = torch.cat([src, torch.ones((src.shape[0], 1), dtype=src.dtype,
                                       device=src.device)], dim=1)

    def residual(hv):
        proj = src_h @ hv.reshape(3, 3).T
        return (proj[:, :2] / proj[:, 2:3] - dst).reshape(-1)

    eye = torch.eye(9, dtype=h_mat.dtype, device=h_mat.device)
    hv = h_mat.reshape(9)
    for _ in range(iters):
        r = residual(hv)
        with _JACFWD_LOCK:  # forward-AD levels are process-wide (geometry/pnp.py)
            j = torch.func.jacfwd(residual)(hv)
        upd = -torch.linalg.solve(j.T @ j + 1e-9 * eye, j.T @ r)
        hv = hv + torch.where(torch.isfinite(upd).all(), upd, torch.zeros_like(upd))
    return hv.reshape(3, 3)
