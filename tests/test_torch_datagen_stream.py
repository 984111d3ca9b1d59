"""The trainers' data maker on a CUDA stream of its own (``datagen.on_own_stream``, called
by ``cli.train.family_setup``'s ``make_batch``).

On the CPU the maker runs inline: ``family_setup``'s batches are ``datagen.icn_batch``'s
from the same seed, nothing is counted and no ``fusg.datagen.stream`` span is recorded;
under a dispatch mode (fake tensors, ``torch.export``) the helper steps aside on a CUDA
device too.

On the card (marker ``chip``; they skip without one) the batches made on the stream are
bit-equal to the inline ones (3 ICN, 2 VUNet) and counted; the maker's stream syncs do
not wait for 300 ms of sleep queued on the caller's stream (the inline maker's do); a
consumer on the caller's stream reads the finished batch; and 20 batches freed
while slow steps read them are read unchanged afterwards, so the allocator handed no
block back to the maker early. This file imports no JAX, so that the card's cases run
there: ``python -m pytest --noconftest tests/test_torch_datagen_stream.py -m chip``.
"""
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from future_urban_scene_generation_tpu_torch.cli import train as cli_train
from future_urban_scene_generation_tpu_torch.pipeline import datagen, training
from future_urban_scene_generation_tpu_torch.utils import profiling
import torch_threads  # noqa: F401

STREAM_SPAN = "fusg.datagen.stream"


def _inline_icn(seed: int, batch: int, n: int, device):
    """``n`` ICN batches as ``family_setup("icn")`` draws them, made inline: the data
    source, the trainer's initial draws from the same generator, then ``icn_batch``."""
    generator, bank, frame, intrinsic = cli_train.icn_setup(seed, device)
    training.ICNTrainer(lr=1e-4).init(generator, device=device)
    with torch.no_grad():
        return [tuple(datagen.icn_batch(generator, bank, frame, intrinsic, batch=batch,
                                        vis_res=192)) for _ in range(n)]


def _inline_vunet(seed: int, batch: int, n: int, device):
    """As :func:`_inline_icn` for ``family_setup("vunet")`` (its CUDA noise generator
    left out: it is passed through, not made)."""
    generator, bank, frame, intrinsic = cli_train.icn_setup(seed, device)
    training.VunetTrainer(vunet_256=True, lr=1e-4).init(generator, device=device)
    with torch.no_grad():
        return [tuple(datagen.vunet_batch(generator, bank, frame, intrinsic, batch=batch))
                for _ in range(n)]


def _setup(model: str, seed: int, batch: int, device):
    return cli_train.family_setup(model, seed=seed, batch=batch, lr=1e-4, image_size=256,
                                  device=device)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# On the CPU: the maker inline.


def test_cpu_batches_are_the_inline_ones_and_uncounted():
    cpu = torch.device("cpu")
    _trainer, _state, make_batch = _setup("icn", 7, 1, cpu)
    before = {s.span_id for s in profiling.spans()}
    got = [make_batch() for _ in range(3)]
    spans = [s for s in profiling.spans() if s.span_id not in before]
    for g, w in zip(got, _inline_icn(7, 1, 3, cpu)):
        _equal(g, w)
    assert [s.request for s in spans if s.name == "fusg.datagen"] == [0, 1, 2]
    assert not [s for s in spans if s.name == STREAM_SPAN]
    assert datagen.STREAM_BATCHES == 0


class _Passthrough(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def test_helper_steps_aside_on_the_cpu_and_under_a_dispatch_mode():
    def make():
        return (torch.ones(2),)

    assert datagen.on_own_stream(make, "cpu") is make
    on_card = datagen.on_own_stream(make, "cuda")
    assert on_card is not make
    # Under a dispatch mode (fake tensors, ``torch.export``) it calls ``make`` inline and
    # touches no CUDA API, so this runs on a CPU-only torch too.
    with _Passthrough():
        (out,) = on_card()
    assert torch.equal(out, torch.ones(2)) and datagen.STREAM_BATCHES == 0


# ---------------------------------------------------------------------------
# On the card.


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cycles_per_ms() -> float:
    """``torch.cuda._sleep``'s cycles a millisecond on this card, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)  # warm
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def _sleep_ms(ms: float, cycles_per_ms: float) -> None:
    torch.cuda._sleep(int(ms * cycles_per_ms))


@pytest.mark.chip
def test_batches_on_the_stream_are_bit_equal_and_counted(card):
    before = datagen.STREAM_BATCHES
    spans_before = {s.span_id for s in profiling.spans()}
    _t, _s, icn_batch = _setup("icn", 11, 8, card)
    got_icn = [icn_batch() for _ in range(3)]
    _t, _s, vunet_batch = _setup("vunet", 12, 4, card)
    got_vunet = [vunet_batch() for _ in range(2)]
    assert datagen.STREAM_BATCHES - before == 5
    spans = [s for s in profiling.spans() if s.span_id not in spans_before]
    batches = {s.span_id for s in spans if s.name == "fusg.datagen"}
    assert sorted(s.parent_id for s in spans if s.name == STREAM_SPAN) == sorted(batches)
    for g, w in zip(got_icn, _inline_icn(11, 8, 3, card)):
        _equal(g, w)
    for g, w in zip(got_vunet, _inline_vunet(12, 4, 2, card)):
        assert isinstance(g[0], torch.Generator)  # the noise generator, passed through
        _equal(g[1:], w)


@pytest.mark.chip
def test_the_makers_syncs_do_not_wait_for_the_callers_queue(card):
    """Behind 300 ms of sleep queued on the caller's stream, a maker with the stream syncs
    the ICN maker makes (a pageable upload, ``eigh``'s check, ``nonzero``, a value read)
    returns while the sleep runs, and the ICN maker's draws and views (the draws' upload,
    the visibility tables) end long before it; inline, the draws' upload waits the sleep
    out, so the check bites. The ICN maker's pairs do wait: MAGMA's batched
    ``cholesky_solve`` in the homographies' polish frees device memory (``cudaFree``),
    which waits for every stream of the device."""
    cycles, sleep_ms = _cycles_per_ms(), 300.0

    def syncs():
        x = torch.tensor([1.0, -2.0, 3.0], device=card)
        torch.linalg.eigh(2 * torch.eye(3, device=card).expand(4, 3, 3))
        return torch.nonzero(x > 0), float(x.sum())

    def behind_sleep(make):
        """Host ms from the sleep's enqueue to the end of each span ``make`` opened, and
        whether the sleep had ended when ``make`` returned."""
        torch.cuda.synchronize()
        before = {s.span_id for s in profiling.spans()}
        t0 = time.time_ns()  # the spans' clock
        _sleep_ms(sleep_ms, cycles)
        slept = torch.cuda.Event()
        slept.record()
        make()
        done = slept.query()
        torch.cuda.synchronize()
        ends = {s.name: (s.end_ns - t0) / 1e6 for s in profiling.spans()
                if s.span_id not in before}
        return ends, done

    own = datagen.on_own_stream(syncs, card)
    own()  # warm: the solver's handle
    assert not behind_sleep(own)[1], "a stream sync waited for the caller's queue"
    _t, _s, make_batch = _setup("icn", 13, 8, card)
    make_batch()
    make_batch()
    ends, _ = behind_sleep(make_batch)
    assert ends["fusg.datagen.views"] < sleep_ms / 2, ends
    generator, bank, frame, intrinsic = cli_train.icn_setup(13, card)
    with torch.no_grad():
        ends, _ = behind_sleep(lambda: datagen.icn_batch(generator, bank, frame, intrinsic,
                                                         batch=8, vis_res=192))
    assert ends["fusg.datagen.draws"] > 0.8 * sleep_ms, ends


@pytest.mark.chip
def test_the_callers_stream_reads_the_finished_batch(card):
    """A maker whose kernels run behind 50 ms of sleep on its own stream: the caller's
    stream reads what it wrote, not the memory before it."""
    cycles = _cycles_per_ms()
    caller = torch.cuda.current_stream(card)
    seen = []

    def make(value):
        stream = torch.cuda.current_stream(card)
        seen.append(stream)
        x = torch.empty(1 << 20, device=card)
        _sleep_ms(50, cycles)
        x.fill_(value)
        return (x,)

    for value in (3.0, 5.0, 7.0):
        value_batch = datagen.on_own_stream(lambda: make(value), card)
        (x,) = value_batch()
        assert float((x * 2).min()) == float((x * 2).max()) == 2 * value
    assert all(s != caller for s in seen) and seen[0].priority < caller.priority


@pytest.mark.chip
def test_batches_freed_while_steps_read_them_stay_intact(card):
    """20 batches, each freed while a slow step on the caller's stream has still to copy
    it: with no record of that use the maker's stream would take its block back for the
    next batch before the copy ran."""
    cycles = _cycles_per_ms()
    _t, _s, make_batch = _setup("icn", 17, 2, card)
    make_batch()
    torch.cuda.synchronize()
    t = time.perf_counter()
    make_batch()
    step_ms = max(20.0, 3e3 * (time.perf_counter() - t))
    _t, _s, make_batch = _setup("icn", 17, 2, card)
    held = []
    for _ in range(20):
        batch = make_batch()
        _sleep_ms(step_ms, cycles)  # the step, still running when the batch is freed
        held.append(tuple(x.clone() for x in batch))
        del batch
    torch.cuda.synchronize()
    for g, w in zip(held, _inline_icn(17, 2, 20, card)):
        _equal(g, w)
