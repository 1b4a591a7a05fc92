import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

# The target container has no hypothesis and pip installs are forbidden;
# fall back to the deterministic shim so property tests still run.
try:
    import hypothesis  # noqa: F401
except ImportError:
    _spec = importlib.util.spec_from_file_location(
        "hypothesis", os.path.join(os.path.dirname(__file__),
                                   "_hypothesis_shim.py"))
    _shim = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_shim)
    sys.modules["hypothesis"] = _shim
    sys.modules["hypothesis.strategies"] = _shim.strategies


def pytest_configure(config):
    # Quick tier: `pytest -m "not slow"` skips the forced-host subprocess
    # tests (each spawns a fresh 8-device python, ~10-60 s apiece).
    config.addinivalue_line(
        "markers",
        "slow: forced-host subprocess tests (sharded meshes, int64-x64); "
        "deselect with -m 'not slow' for the quick tier")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); "
        "skips without one")


def run_subprocess(code: str, devices: int = 8, timeout: int = 600,
                   extra_env=None):
    """Run python code in a fresh process with N fake host devices.

    Needed because the main pytest process must keep the default single
    CPU device (smoke tests and benches see 1 device per the assignment).
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices}")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=timeout, env=env)
    if r.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={r.returncode})\n--- stdout ---\n"
            f"{r.stdout[-4000:]}\n--- stderr ---\n{r.stderr[-4000:]}")
    return r.stdout


@pytest.fixture
def subproc():
    return run_subprocess
