"""The benchmark's own tests: `python -m pytest evcbench/tests -q` (CPU);
the card's: `python -m pytest evcbench/tests -q -m cuda` on a machine
with one."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
