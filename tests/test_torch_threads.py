"""The guard of ``torch_threads``: a worker's torch and its children get the worker's
share of the cores, and never fewer than two threads."""
import os

import torch

import torch_threads  # noqa: F401


def test_threads_are_the_workers_share_of_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    want = max(2, len(os.sched_getaffinity(0)) // workers)
    assert torch.get_num_threads() == want
    assert os.environ["OMP_NUM_THREADS"] == str(want)
