"""The VUNet's serving passes as captured CUDA graphs (``pipeline/graphs.py``, called by
``stages.vunet_encode_appearance_batch`` / ``vunet_decode_batch``).

On the CPU every call is the eager pass, bit for bit, and so is a call with grad on, on
fake tensors, under a dispatch mode or inside ``torch.export``: the helper steps aside.
With a stub capturer (its graph reruns the pass on the static buffers) the helper's
bookkeeping runs on the CPU: a key's first call is eager, its second captures and
replays, later ones replay; a new shape or a weight load is a new key; the cache keeps
:data:`graphs.MAX_KEYS` keys; a replay's clone is the caller's own, and its span is a
child of the caller's.

On the card (marker ``chip``; they skip without one) the replay is bit-equal to the eager
pass at N = 24 under ``SERVING_SPEC`` (bf16) and ``ModelSpec()`` (f32) and at N = 96 in
f32, two replays with different inputs are both right, threads replaying on their own
streams each get their own answers, and the profiler files the graph's kernels under the
caller's ``fusg.vunet_decode``, as ``generators.device_ms`` reads them. This file imports
no JAX, so that the card's cases run there:
``python -m pytest --noconftest tests/test_torch_vunet_graph.py -m chip``.
"""
import threading

import pytest
import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from future_urban_scene_generation_tpu_torch.models.layers import WNConv2d, seeded_init_
from future_urban_scene_generation_tpu_torch.models.vunet import Vunet
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.pipeline import graphs, stages
from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC, ModelSpec
from future_urban_scene_generation_tpu_torch.utils import profiling
import torch_threads  # noqa: F401

SPAN = stages.VUNET_REPLAY


def _vunet(device, seed: int = 0) -> Vunet:
    net = Vunet().eval().requires_grad_(False)
    seeded_init_(net, torch.Generator().manual_seed(seed))
    return net.to(device)


def _stage_inputs(v: int, s: int, res: int, device, seed: int):
    """The two stages' arguments after models and spec: (frame, source sketches, masks,
    windows) of V vehicles and the N = V x S destination sketches."""
    g = torch.Generator().manual_seed(seed)
    frame = torch.rand(2 * res, 3 * res, 3, generator=g)
    sketches = torch.rand(v, res, res, 3, generator=g)
    masks = torch.rand(v, res, res, generator=g) > 0.3
    x0 = torch.rand(v, generator=g) * res
    y0 = torch.rand(v, generator=g) * res / 2
    side = res / 2 + torch.rand(v, generator=g) * res / 2
    window = cr.Window(x0, y0, side, side)
    dst = torch.rand(v * s, res, res, 3, generator=g)
    return (frame.to(device), sketches.to(device), masks.to(device),
            window.map(lambda f: f.to(device)), dst.to(device))


def _scene_passes(models, spec, inputs, s: int):
    """The encode and decode as ``runner.generate`` calls them."""
    frame, sketches, masks, window, dst = inputs
    mu = stages.vunet_encode_appearance_batch(models, spec, frame, sketches, masks, window)
    return mu, stages.vunet_decode_batch(models, spec, dst,
                                         [m.repeat_interleave(s, dim=0) for m in mu])


def _equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# On the CPU: the eager passes, and the helper stepping aside.


@torch.no_grad()
def test_cpu_calls_are_the_eager_passes():
    """Twice through the stages (a second call on the card would capture) and once through
    the helper: each the eager pass, bit for bit, and nothing warmed or counted."""
    net = _vunet("cpu")
    models = stages.Models(None, None, None, net)
    frame, sketches, masks, window, dst = inputs = _stage_inputs(1, 1, 256, "cpu", seed=3)
    veh = cr.crop_resize(frame, window, stages.CROP)
    x = torch.cat([torch.where(masks[..., None], veh, torch.ones_like(veh)) * 2.0 - 1.0,
                   sketches * 2.0 - 1.0], dim=-1)
    want_mu = net.encode_appearance(x)
    want = torch.clamp((net.decode_shape(dst * 2.0 - 1.0, want_mu) + 1.0) / 2.0, 0.0, 1.0)
    before = (graphs.CAPTURES, graphs.REPLAYS)
    for _ in range(2):
        mu, out = _scene_passes(models, ModelSpec(), inputs, 1)
        assert _equal(mu, want_mu) and torch.equal(out, want)
    assert _equal(graphs.call(Vunet.encode_appearance, net, x, span=SPAN), want_mu)
    assert (graphs.CAPTURES, graphs.REPLAYS) == before
    assert net not in graphs._CACHES


class Tiny(nn.Module):
    """A pass with a nested input and two outputs, a weight-normed conv inside."""

    def __init__(self):
        super().__init__()
        self.conv = WNConv2d(3, 4, 3, 1, 1)

    def step(self, x, ys):
        y = self.conv(x) + ys[0]
        return [y, (y * ys[1]).sum(dim=(1, 2))]


def _tiny():
    net = Tiny().eval().requires_grad_(False)
    seeded_init_(net, torch.Generator().manual_seed(1))
    return net


def _tiny_args(b: int = 2, hw: int = 8, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, hw, hw, 3, generator=g),
            [torch.randn(b, hw, hw, 4, generator=g), torch.randn(b, hw, hw, 4, generator=g)])


class _StubCapturer:
    """``graphs._capture`` on the CPU: static buffers as the real one allocates them, and
    a graph whose replay reruns the pass on them into the static outputs."""

    def __init__(self):
        self.keys = []

    def __call__(self, cache, fn, leaves, in_spec):
        inputs = [torch.empty_like(x) for x in leaves]
        out = fn(*tree_unflatten(inputs, in_spec))
        flat = tree_flatten(out)[0]

        class Replayer:
            def replay(self):
                for o, r in zip(flat, tree_flatten(fn(*tree_unflatten(inputs, in_spec)))[0]):
                    o.copy_(r)

        self.keys.append(tuple(tuple(x.shape) for x in leaves))
        return graphs._Graph(Replayer(), inputs, out, cache, leaves[0].device)


@pytest.fixture
def stub(monkeypatch):
    """CPU tensors engage, and captures go to the stub."""
    capturer = _StubCapturer()
    monkeypatch.setattr(graphs, "_on_card", lambda t: type(t) is torch.Tensor)
    monkeypatch.setattr(graphs, "_capture", capturer)
    return capturer


def _counts():
    return graphs.CAPTURES, graphs.REPLAYS


def _delta(before):
    return graphs.CAPTURES - before[0], graphs.REPLAYS - before[1]


@pytest.mark.parametrize("mode", ["grad", "fake", "dispatch_mode", "export"])
def test_grad_fake_and_traced_calls_step_aside(stub, mode):
    """Even where CPU tensors engage, a call with grad on, on fake tensors, under a
    dispatch mode or inside a non-strict ``torch.export`` is the eager pass: nothing is
    warmed, captured or replayed."""
    net = _tiny()
    args = _tiny_args()
    want = net.step(*args)
    before = _counts()
    for _ in range(3):
        if mode == "grad":
            with torch.enable_grad():
                got = graphs.call(Tiny.step, net, *args, span=SPAN)
            assert _equal(got, want)
        elif mode == "fake":
            from torch._subclasses.fake_tensor import FakeTensorMode

            with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True) as fm:
                fake = tree_unflatten([fm.from_tensor(t) for t in tree_flatten(args)[0]],
                                      tree_flatten(args)[1])
                got = graphs.call(Tiny.step, net, *fake, span=SPAN)
            assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
        elif mode == "dispatch_mode":
            from torch.utils.flop_counter import FlopCounterMode

            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                got = graphs.call(Tiny.step, net, *args, span=SPAN)
            assert fc.get_total_flops() > 0 and _equal(got, want)
        else:
            class Wrapper(nn.Module):
                def __init__(self):
                    super().__init__()
                    self.net = net

                def forward(self, x, y0, y1):
                    return graphs.call(Tiny.step, self.net, x, [y0, y1], span=SPAN)

            with torch.no_grad():
                ep = torch.export.export(Wrapper(), (args[0], *args[1]), strict=False)
            assert any("conv" in str(n.target) for n in ep.graph.nodes), ep.graph
            assert _equal(ep.module()(args[0], *args[1]), want)
    assert _delta(before) == (0, 0) and not stub.keys
    assert net not in graphs._CACHES or not graphs._CACHES[net].entries


@torch.no_grad()
def test_second_call_captures_third_replays(stub):
    """Call 1 is eager, call 2 captures and replays, call 3 replays; each replay's span
    is a child of the caller's span."""
    net = _tiny()
    args = _tiny_args()
    want = net.step(*args)
    steps = []
    for _ in range(3):
        before = _counts()
        with profiling.trace("fusg.vunet_decode"):
            got = graphs.call(Tiny.step, net, *args, span=SPAN)
        steps.append(_delta(before))
        assert _equal(got, want)
    assert steps == [(0, 0), (1, 1), (0, 1)]
    assert len(stub.keys) == 1
    spans = profiling.spans()
    callers = {s.span_id for s in spans if s.name == "fusg.vunet_decode"}
    replays = [s for s in spans if s.name == SPAN and s.parent_id in callers]
    assert len(replays) >= 2


def _scaled(net, k: float, x, ys):
    return [t * k for t in net.step(x, ys)]


@pytest.mark.parametrize("change", ["shape", "weights", "parameter", "static"])
@torch.no_grad()
def test_a_new_key_warms_and_captures_anew(stub, change):
    """A new input shape, a weight load (it bumps the parameters' versions), a parameter
    replaced by another, or another static argument is a new key: eager once, then its
    own capture; the old graph is not replayed for it."""
    net, args, k = _tiny(), _tiny_args(), 2.0
    for _ in range(3):
        graphs.call(_scaled, net, *args, span=SPAN, static=(k,))
    assert len(stub.keys) == 1
    if change == "shape":
        args = _tiny_args(b=3)
    elif change == "weights":
        net.load_state_dict({n: t * 0.5 for n, t in net.state_dict().items()})
    elif change == "parameter":
        net.conv.bias = nn.Parameter(net.conv.bias + 1.0, requires_grad=False)
    else:
        k = 3.0
    steps = []
    for _ in range(3):
        before = _counts()
        got = graphs.call(_scaled, net, *args, span=SPAN, static=(k,))
        steps.append(_delta(before))
    assert steps == [(0, 0), (1, 1), (0, 1)] and len(stub.keys) == 2
    assert _equal(got, _scaled(net, k, *args))


@torch.no_grad()
def test_the_encode_stage_through_the_stub(stub):
    """The encode stage as the scene calls it (a named tuple of window fields among its
    inputs, the spec as its static argument): eager, capture, replay, each equal to the
    eager stage."""
    models = stages.Models(None, None, None, _vunet("cpu"))
    frame, sketches, masks, window, _ = _stage_inputs(1, 1, 256, "cpu", seed=4)
    want = stages._vunet_encode(models.vunet, ModelSpec(), frame, sketches, masks, window)
    steps = []
    for _ in range(3):
        before = _counts()
        got = stages.vunet_encode_appearance_batch(models, ModelSpec(), frame, sketches, masks,
                                                   window)
        steps.append(_delta(before))
        assert _equal(got, want)
    assert steps == [(0, 0), (1, 1), (0, 1)]


@torch.no_grad()
def test_cache_stays_at_its_bound(stub):
    net = _tiny()
    sizes = range(1, graphs.MAX_KEYS + 4)
    for b in sizes:
        for _ in range(2):
            graphs.call(Tiny.step, net, *_tiny_args(b=b), span=SPAN)
    entries = graphs._CACHES[net].entries
    assert len(entries) == graphs.MAX_KEYS
    assert all(isinstance(e, graphs._Graph) for e in entries.values())
    assert len(stub.keys) == len(sizes)
    # The oldest key was dropped: it warms again before it captures again.
    before = _counts()
    graphs.call(Tiny.step, net, *_tiny_args(b=1), span=SPAN)
    assert _delta(before) == (0, 0)
    assert len(graphs._CACHES[net].entries) == graphs.MAX_KEYS


@torch.no_grad()
def test_replay_clones_are_the_callers_own(stub):
    net = _tiny()
    a, b = _tiny_args(seed=1), _tiny_args(seed=2)
    for _ in range(2):
        graphs.call(Tiny.step, net, *a, span=SPAN)
    got_a = graphs.call(Tiny.step, net, *a, span=SPAN)
    got_b = graphs.call(Tiny.step, net, *b, span=SPAN)
    assert _equal(got_a, net.step(*a)) and _equal(got_b, net.step(*b))
    assert not _equal(got_a, got_b)


# ---------------------------------------------------------------------------
# On the card: replays against the eager pass on the same CUDA tensors.


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _eager(models, spec, inputs, s):
    """The scene's two passes with the helper stepped aside (grad on; the VUNet's
    parameters need none, so nothing is recorded for autograd)."""
    with torch.enable_grad():
        return _scene_passes(models, spec, inputs, s)


@pytest.mark.chip
@pytest.mark.parametrize("spec_name,v", [("serving_bf16", 4), ("default_f32", 4),
                                         ("default_f32", 16)])
@torch.no_grad()
def test_replay_is_bit_equal_to_eager(card, spec_name, v):
    s = 6  # N = 24 at V = 4, 96 at V = 16
    spec = SERVING_SPEC if spec_name == "serving_bf16" else ModelSpec()
    models = stages.Models(None, None, None, _vunet(card, seed=v))
    inputs = _stage_inputs(v, s, 256, card, seed=v)
    want = _eager(models, spec, inputs, s)
    before = _counts()
    got = [_scene_passes(models, spec, inputs, s) for _ in range(3)]
    torch.cuda.synchronize()
    assert _delta(before) == (2, 4)  # each pass: eager, capture + replay, replay
    for g in got:
        for a, b in zip(tree_flatten(g)[0], tree_flatten(want)[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got[0][1].dtype == torch.float32 and got[0][0][0].dtype == spec.gen_dtype


@pytest.mark.chip
@torch.no_grad()
def test_replays_with_other_inputs_keep_each_answer(card):
    spec, s = SERVING_SPEC, 6
    models = stages.Models(None, None, None, _vunet(card))
    ins = [_stage_inputs(4, s, 256, card, seed=k) for k in (11, 12, 13)]
    for _ in range(2):
        _scene_passes(models, spec, ins[0], s)
    before = _counts()
    got = [_scene_passes(models, spec, x, s) for x in ins]
    torch.cuda.synchronize()
    assert _delta(before) == (0, 6)
    for g, x in zip(got, ins):
        for a, b in zip(tree_flatten(g)[0], tree_flatten(_eager(models, spec, x, s))[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(got[0][1], got[1][1])


@pytest.mark.chip
@torch.no_grad()
def test_threads_on_their_own_streams_get_their_own_answers(card):
    spec, s, rounds = SERVING_SPEC, 6, 4
    models = stages.Models(None, None, None, _vunet(card))
    ins = [_stage_inputs(4, s, 256, card, seed=k) for k in (21, 22)]
    for _ in range(2):
        _scene_passes(models, spec, ins[0], s)
    torch.cuda.synchronize()
    results, errors = [[], []], []
    barrier = threading.Barrier(2)

    def work(i):
        try:
            stream = torch.cuda.Stream()
            barrier.wait(timeout=60)
            with torch.no_grad(), torch.cuda.stream(stream):
                for _ in range(rounds):
                    results[i].append(_scene_passes(models, spec, ins[i], s))
                stream.synchronize()
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, e))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for i in range(2):
        want = tree_flatten(_eager(models, spec, ins[i], s))[0]
        assert len(results[i]) == rounds
        for g in results[i]:
            for a, b in zip(tree_flatten(g)[0], want):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.chip
@torch.no_grad()
def test_profiler_files_the_replay_under_the_callers_span(card):
    """The graph's kernels carry the correlation of ``fusg::graph_replay``, begun inside
    ``fusg.vunet_decode`` and its replay span: ``perfbench.harness.trace.reduce`` files
    them there, as many as the eager pass launches and its copies."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness import trace as ptrace

    spec, s = SERVING_SPEC, 6
    models = stages.Models(None, None, None, _vunet(card))
    frame, sketches, masks, window, dst = _stage_inputs(4, s, 256, card, seed=5)
    mu = stages.vunet_encode_appearance_batch(models, spec, frame, sketches, masks, window)
    mu = [m.repeat_interleave(s, dim=0) for m in mu]

    def traced(grad: bool):
        for _ in range(3):  # a profiler session on the card now and then records nothing
            with torch.set_grad_enabled(grad), profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with profiling.trace("fusg.vunet_decode"):
                    stages.vunet_decode_batch(models, spec, dst, mu)
                torch.cuda.synchronize()
            tr = ptrace.reduce(prof.profiler.kineto_results.events(), 1)
            if tr.kernels:
                return tr
        return tr

    for _ in range(2):  # eager, then capture and replay
        stages.vunet_decode_batch(models, spec, dst, mu)
    eager = traced(grad=True)
    replay = traced(grad=False)
    assert not any(SPAN in k.spans for k in eager.kernels)
    stray = [(k.name, k.spans) for k in replay.kernels
             if not {"fusg.vunet_decode", SPAN} <= set(k.spans)]
    assert not stray, stray[:5]
    assert len(replay.kernels) >= len(eager.kernels) > 500
