"""Run one cell of the benchmark on the machine this is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: reads ``BENCHMARK.json`` and the cell's files, builds the
port's side from inputs made from ``--seed`` (set-up, timed as ``setup_s``), measures
``--seconds`` of the cell's traffic, and then holds what the timed path produced
against the plain reference. With ``--trace 1`` a steady stretch of the window is
profiled and the cell's per-layer metrics are reported instead of its end-to-end ones.

The last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers are the last
lines of standard error. Exit codes: 0 with a result; 2 without the cards the cell
needs; 3 if JAX or the JAX package was loaded; 1 on any other failure. No result is
printed unless the code is 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Every build and kernel cache the run may fill lies at a fixed path in the checkout.
CACHE = ROOT / ".perfbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from perfbench.harness import bench, device as devrec, jaxcheck  # noqa: E402
from perfbench.harness.trace import Tracer  # noqa: E402
from perfbench.judge import checks as judge_checks, passed  # noqa: E402

IMPORT_S = time.perf_counter() - T_START


class Run:
    """One run of a cell: what the entry, the metric readers and the judge share."""

    def __init__(self, cell: bench.Cell, seed: int, seconds: float, trace: bool, device):
        self.cell, self.seed, self.seconds, self.trace_on = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.setup_parts = {"import_s": IMPORT_S}
        spec = cell.cell.get("trace", {})
        self.tracer = Tracer(spec.get("first", 0), spec.get("count", 0) if trace else 0)
        self.window = None
        self.setup_s = None

    @property
    def trace(self):
        return self.tracer.trace

    def init_device(self) -> None:
        """The CUDA context, and TF32 off as the port's entry points set it."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            torch.zeros(1, device=self.device)
            torch.cuda.synchronize()

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def metric_values(run: Run, metrics) -> dict:
    """Each metric's reading by its reader; a reader that finds nothing is left out."""
    out = {}
    for m in metrics:
        value = run.cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def drive(cell: bench.Cell, seed: int, seconds: float, trace: bool, device,
          on_window=None, t0: float = T_START):
    """Set-up, the window and the release of the port's side, as every run makes them:
    returns (run, entry, what the judge reads). ``on_window(run)`` is called once the
    window has closed, before the port's side is freed; ``setup_s`` runs from ``t0``."""
    run = Run(cell, seed, seconds, trace, device)
    entry = cell.entry()
    state = entry.setup(run)
    run.setup_s = time.perf_counter() - t0
    log("setup " + json.dumps({k: round(v, 4) for k, v in run.setup_parts.items()}
                              | {"setup_s": round(run.setup_s, 4)}))
    jaxcheck.check("after set-up")
    run.window = entry.window(run, state)
    jaxcheck.check("after the window")
    log("window " + json.dumps({k: v for k, v in run.window.items()
                                if not isinstance(v, list)}))
    if on_window is not None:
        on_window(run)
    held = entry.release(run, state)
    del state
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return run, entry, held


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, device=None) -> dict:
    """Run the cell and return the result line's object. ``device`` other than a card
    is for the benchmark's own tests on the CPU."""
    cell = bench.load_cell(root, workload)
    if device is None:
        devrec.require_cuda(cell.workload["chips"])
        device = "cuda:0"
    read = {}

    def on_window(run):
        read["device"] = devrec.record(run.device, cell.workload["chips"])
        read["metrics"] = metric_values(run, cell.per_layer if trace else cell.end_to_end)

    run, entry, held = drive(cell, seed, seconds, trace, device, on_window)
    dev = read["device"]
    t_judge = time.perf_counter()
    readings = entry.judge(run, held)
    checks = judge_checks(readings, cell.cell["limits"])
    log("readings " + json.dumps(readings)
        + f" judge_s {time.perf_counter() - t_judge:.3f}")
    result = {"correct": passed(checks), "attempted": run.window["attempted"],
              "failed": run.window["failed"], "metrics": read["metrics"], "device": dev}
    if trace:
        if run.trace is None:
            raise RuntimeError("the traced stretch never ran: the window is too short")
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    jaxcheck.check("at the end")
    for name, value, limit in checks:
        log(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAIL'}")
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    except devrec.NoDevice as e:
        log(f"no device: {e}")
        return 2
    except jaxcheck.JaxLoaded as e:
        log(str(e))
        return 3
    except Exception:  # noqa: BLE001 - the boundary: report and fail the run
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
