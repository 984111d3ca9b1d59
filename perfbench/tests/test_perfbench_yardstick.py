"""The yardstick's arithmetic and the no-JAX check."""
import pytest

from perfbench.harness import jaxcheck
from perfbench.roofline import kernels as rk


def test_roofline_reckonings_reproduce_the_kernel_table():
    # 24 renders of 1,944 triangles at 256^2: 23.81 MB moved once.
    n_bytes, _ = rk.k1_call(24, 1944, 256, 256)
    assert round(n_bytes / 1e6, 2) == 23.81
    # K2 at N = 24, V = 4, 256^2, 21 -> 64, 7x7: 2.07e11 FLOP.
    _, flop = rk.k2_call(24, 4, 256, 256)
    assert round(flop / 1e11, 2) == 2.07
    # K3 at the trainer's stem, 8 x 262^2 x 21 -> 64: 6.9e10 FLOP.
    _, flop = rk.k3_call(8, 262, 262, 21, 7, 64)
    assert round(flop / 1e10, 1) == 6.9
    assert rk.bound_s(23.81e6, 0, rk.PEAK_F32) == pytest.approx(7.107e-6, rel=1e-3)


def test_kernel_names():
    assert rk.is_k1("void raster_tiles_kernel(float const*, float4 const*)")
    assert rk.is_k2("void conv_fma_kernel<StemLoader<float> >(StemLoader<float>, float const*)")
    assert rk.is_k3("void conv_fma_kernel<PaddedLoader<float> >(PaddedLoader<float>)")
    assert not rk.is_k3("void conv_fma_kernel<StemLoader<float> >(StemLoader<float>)")


@pytest.mark.parametrize("planted", ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                     "optax", "orbax.checkpoint",
                                     "future_urban_scene_generation_tpu",
                                     "future_urban_scene_generation_tpu.ops.crop"])
def test_no_jax_check_fails_on_a_planted_module(planted):
    modules = {"torch": None, "future_urban_scene_generation_tpu_torch.ops": None, planted: None}
    with pytest.raises(jaxcheck.JaxLoaded):
        jaxcheck.check("test", modules)


def test_no_jax_check_passes_the_port():
    jaxcheck.check("test", {"future_urban_scene_generation_tpu_torch": None,
                            "future_urban_scene_generation_tpu_torch.pipeline.runner": None,
                            "jaxtyping_like": None, "numpy": None})


class _Event:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, name, device, start, dur, corr=0, linked=0, annotation=False):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if device else DeviceType.CPU, start, dur, corr,
                   linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_trace_reduction_attributes_kernels_to_spans():
    from perfbench.harness.trace import reduce

    events = [
        _Event("fusg.pnp", False, 0, 100, corr=1, annotation=True),
        _Event("aten::mm", False, 10, 5, corr=2),
        _Event("fusg.icn", False, 100, 100, corr=3, annotation=True),
        _Event("aten::conv", False, 110, 5, corr=4),
        _Event("fusg.pnp", True, 0, 100, annotation=True),  # the span mirrored on the device
        _Event("mm_kernel", True, 20, 10, linked=2),
        _Event("conv_kernel", True, 120, 30, linked=4),
        _Event("Memcpy HtoD", True, 150, 20, linked=4),
    ]
    t = reduce(events, units=1)
    assert [k.name for k in t.kernels] == ["mm_kernel", "conv_kernel"]
    assert [k.span for k in t.under("fusg.icn")] == ["fusg.icn"]
    assert t.span_ms("fusg.pnp") == 100 / 1e6
    assert t.busy_s == 40 / 1e9 and t.window_s == 200 / 1e9
    b = t.breakdown()
    assert b["device_ops"] == [["conv_kernel", 30 / 1e9], ["mm_kernel", 10 / 1e9]]
    idle = dict(b["idle_gaps"])
    assert idle["fusg.pnp"] == 110 / 1e9 and idle["fusg.icn"] == 50 / 1e9
