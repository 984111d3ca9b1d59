"""Entry ``stream_int8``: the camera stream of ``entries/stream.py`` (its set-up, window
and release) on a configuration with ``quantized_convs``, judged by
``judge/scene_int8.py`` against the plain reference on the int8 tier.

The window also keeps what the port's ICN took and gave in the newest run of each pool
scene the judge samples (``judge/scene.sample`` over the whole pool, the judge's own
sample once the window has finished every pool scene, as a window of seconds does): the
stem's activation (the trunk's input) and the trunk's output, so that the judge can hold
the trunk's int8 convs to the reference on the program's own input. They are references
to tensors the scene made, no copies: ~1.7 GB a kept scene at N = 96, held on the card
until the judge has read them.
"""
from __future__ import annotations

from pathlib import Path

from perfbench.harness import bench

_stream = bench.load_module(Path(__file__).with_name("stream.py"))
setup = _stream.setup


def window(run, st) -> dict:
    """``stream.py``'s window, with the sampled pool scenes' newest ICN trunk input and
    output kept in ``st.icn``."""
    from perfbench.judge import scene

    wanted = set(scene.sample(run.seed, dict.fromkeys(range(len(st.pool))),
                              run.cell.cell["judge"]["scenes"]))
    frames = {id(sc.frame): k for k, sc in enumerate(st.pool)}
    st.icn, current = {}, [None]
    submit = st.stream.submit

    def tagged(frame, *args, **kwargs):
        current[0] = frames.get(id(frame))
        return submit(frame, *args, **kwargs)

    def keep(module, args, kwargs, out):
        if kwargs.get("from_stem") and current[0] in wanted:
            st.icn[current[0]] = (args[0], out)

    st.stream.submit = tagged
    hook = st.models.icn.register_forward_hook(keep, with_kwargs=True)
    try:
        return _stream.window(run, st)
    finally:
        hook.remove()
        del st.stream.submit


def release(run, st) -> dict:
    """``stream.py``'s release, plus the kept ICN trunks."""
    icn = st.icn
    held = _stream.release(run, st)
    held["icn"] = icn
    return held


def judge(run, held: dict):
    from perfbench.judge import scene_int8

    return scene_int8.judge(run, held)
