"""Test settings for the benchmark's own tests: the port's sources on the
path (as ``run.py`` puts them there) and the ``cuda`` marker."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
