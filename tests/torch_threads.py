"""The port tests' one rule for torch's CPU threads, set once per process on import.

The tier runs N pytest-xdist workers on the machine's cores, and oversubscribed OpenMP
pools made one scene more than ten times slower: each worker takes its share of the cores.
The share is at least two: at one thread torch's CPU kernels sum in other orders, and the
hourglass trainer's float32 step then parts from XLA's (``test_torch_trainers.py``).
``OMP_NUM_THREADS`` carries the count to every subprocess and spawned rank a test starts.
"""
import os

import torch

THREADS = max(2, len(os.sched_getaffinity(0))
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)
