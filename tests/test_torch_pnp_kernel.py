"""Kernel P1 (``csrc/pnp.cu``) behind the operator ``fusg::pnp_cpc``
(geometry/pnp.py), the scene's whole CPC pose solve in one launch.

On the CPU the operator is the plain solve, :func:`pnp.solve_pnp_4restarts`, bit for
bit, and its fake gives the real call's shapes, dtypes and strides. On the card
(marker ``chip``; they skip without one) the kernel is held to the plain solve on the
same CUDA tensors bit for bit (csrc/pnp.cu repeats its operations in their order: a
solve that never converges is chaotic, so anything less moves such a pose by metres),
which is inside tests/test_torch_geometry.py's ``test_solve_poses_matches_jax``
tolerances: V = 1, 4 and 16 cars at the benchmark scene's kind of pose (the
sixteenth's restarts all fail: the chaotic case), keypoint noise 0 and 2 px; a camera
under which every Jacobian collapses (the ``_JTJ_COLLAPSE`` break: every solve frozen
at its restart); a NaN keypoint (the singular-solve break: NaN error, the first
restart); two launches bit-equal. This file imports no JAX, so that the card's cases
run there: ``python -m pytest --noconftest tests/test_torch_pnp_kernel.py -m chip``.
"""
import math

import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu_torch.geometry import pnp
from future_urban_scene_generation_tpu_torch.geometry.projection import project_normalized
from future_urban_scene_generation_tpu_torch.geometry.rotations import (
    matrix_to_rodrigues,
    x_rot,
    z_rot,
)
from future_urban_scene_generation_tpu_torch.utils import mesh as mu
import torch_threads  # noqa: F401

FOCAL, CENTER = 1400.0, (640.0, 360.0)  # the scene cells' camera at 720x1280


def _cars(v: int, noise: float, seed: int = 0, focal: float = FOCAL):
    """(points3d (V, 12, 3), points2d (V, 12, 2), focals, centers) of V test cars at the
    CAD bank's scale, each at the benchmark scene's kind of pose (the camera tilted by
    pi / 2.4, yaw 0.4 + 0.3 v, 2 m below it, 18-27 m ahead), its keypoints projected
    with ``noise`` px of Gaussian noise."""
    _, kp3d = mu.make_test_car(subdiv=1)
    points3d = torch.as_tensor(np.float32(kp3d) * 5.0).expand(v, -1, -1).contiguous()
    yaw = torch.tensor([0.4 + 0.3 * i for i in range(v)])
    rot = x_rot(torch.tensor(-math.pi / 2.4)) @ z_rot(yaw)
    tvec = torch.tensor([[-6.0 + 4.0 * (i % 4), 2.0, 18.0 + 3.0 * (i % 4)] for i in range(v)])
    focals, centers = torch.tensor([focal, focal]), torch.tensor(CENTER)
    points2d = project_normalized(points3d, matrix_to_rodrigues(rot), tvec, focals, centers)
    rng = np.random.RandomState(seed)
    points2d = points2d + torch.as_tensor(np.float32(rng.randn(v, 12, 2) * noise))
    return points3d, points2d, focals, centers


def _on(device, args):
    return tuple(a.to(device) for a in args)


def _assert_equal(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _collapsed():
    """A camera of focal 1e-6 px: every Jacobian's J^T J sums below ``_JTJ_COLLAPSE``
    at the first iteration, so every solve breaks there and keeps its restart."""
    return _cars(2, 0.0, focal=1e-6)


def _nan_keypoint():
    """Two cars, one keypoint of the second NaN: its solves break on a non-finite step
    at the first iteration (mse NaN, the first restart kept)."""
    points3d, points2d, focals, centers = _cars(2, 2.0, seed=3)
    points2d = points2d.clone()
    points2d[1, 5, 0] = float("nan")
    return points3d, points2d, focals, centers


CPU_CASES = {
    "noise0": lambda: _cars(2, 0.0),
    "noise2": lambda: _cars(3, 2.0, seed=1),
    "collapse": _collapsed,
    "nan_keypoint": _nan_keypoint,
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_pnp_cpc_on_cpu_is_the_plain_solve(case):
    """``fusg::pnp_cpc`` on CPU tensors, through the wrapper the scene calls, equals
    :func:`pnp.solve_pnp_4restarts` bit for bit (NaNs where it has them)."""
    args = CPU_CASES[case]()
    got = pnp.pnp_cpc(*args)
    want = pnp.solve_pnp_4restarts(*args)
    _assert_equal(got, want)
    if case == "collapse":  # frozen at the restarts: tvec is the canonical one
        torch.testing.assert_close(got[2], torch.tensor([pnp.CANONICAL_TVEC] * 2))
    if case == "nan_keypoint":
        assert torch.isfinite(got[0][0]) and torch.isnan(got[0][1])


def test_pnp_cpc_fake_matches_real():
    """The fake gives the real call's shapes, dtypes and strides; ``opcheck`` takes the
    autograd registration only (the CPU kernel runs ``jacfwd``, which cannot run under
    a dispatch mode's handler: geometry/pnp.py)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _cars(3, 2.0, seed=2)
    real = pnp.pnp_cpc(*args)
    with FakeTensorMode() as mode:
        fake = pnp.pnp_cpc(*(mode.from_tensor(a) for a in args))
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype, r.stride())
    torch.library.opcheck(torch.ops.fusg.pnp_cpc.default, args,
                          test_utils=("test_autograd_registration",))


# ---------------------------------------------------------------------------
# On the card: the kernel against the plain solve on the same CUDA tensors.


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _kernel_and_plain(args, device):
    args = _on(device, args)
    before = pnp.LAUNCHES
    got = pnp.pnp_cpc(*args)
    torch.cuda.synchronize()
    assert pnp.LAUNCHES == before + 1
    return got, pnp.solve_pnp_4restarts(*args)


@pytest.mark.chip
@pytest.mark.parametrize("noise", [0.0, 2.0])
@pytest.mark.parametrize("v", [1, 4, 16])
def test_kernel_matches_plain(card, v, noise):
    """V cars, keypoint noise 0 (the residual at the float32 floor) and 2 px: the
    kernel's pose and error equal the plain solve's."""
    got, want = _kernel_and_plain(_cars(v, noise, seed=v), card)
    _assert_equal(got, want)
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.chip
def test_kernel_collapsed_jacobians_keep_the_restarts(card):
    got, want = _kernel_and_plain(_collapsed(), card)
    _assert_equal(got, want)
    torch.testing.assert_close(got[2].cpu(), torch.tensor([pnp.CANONICAL_TVEC] * 2))


@pytest.mark.chip
def test_kernel_nan_keypoint_breaks_the_vehicle(card):
    got, want = _kernel_and_plain(_nan_keypoint(), card)
    _assert_equal(got, want)
    assert torch.isfinite(got[0][0]) and torch.isnan(got[0][1])


@pytest.mark.chip
def test_kernel_launches_are_bit_equal(card):
    args = _on(card, _cars(16, 2.0, seed=5))
    _assert_equal(pnp.pnp_cpc(*args), pnp.pnp_cpc(*args))
