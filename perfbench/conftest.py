"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` on the CPU.
Tests that need the card carry the ``chip`` marker and skip, inside a fixture, where
no card is present; on the card: ``python -m pytest perfbench/tests -q -m chip``."""
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skips without one)")
