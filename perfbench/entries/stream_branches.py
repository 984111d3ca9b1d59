"""Entry ``stream_branches``: the camera stream of ``entries/stream.py`` (its set-up,
window and release), judged by ``judge/scene_branches.py``, each branch by numbers of
its own beside the whole frames'."""
from __future__ import annotations

from pathlib import Path

from perfbench.harness import bench

_stream = bench.load_module(Path(__file__).with_name("stream.py"))
setup, window, release = _stream.setup, _stream.window, _stream.release


def judge(run, held: dict):
    from perfbench.judge import scene_branches

    return scene_branches.judge(run, held)
