"""The PyTorch port stands alone: no module of ``src/repro_torch`` and
not ``chip_smoke.py`` imports JAX or the JAX package ``repro``.

An AST scan (no imports, no subprocess): it fails on ``import jax``,
``from jax...``, ``import repro`` / ``from repro...`` (as distinct from
``repro_torch``), wherever in a file they stand.
"""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return sorted(files)


def _forbidden_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # relative import inside the port
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"line {node.lineno}: {name}")
    return bad


def test_port_has_the_slice_modules():
    rel = {os.path.relpath(p, PORT) for p in _port_files()}
    for mod in ("core/dprt.py", "core/geometry.py", "core/plan.py",
                "core/conv.py", "core/dft.py",
                "kernels/sfdprt.py", "kernels/pipeline.py", "kernels/ops.py",
                "kernels/stream.py",
                "kernels/tuning.py", "kernels/ref.py", "kernels/_build.py",
                "radon/operators.py", "radon/autodiff.py", "radon/fusion.py",
                "radon/ambient.py", "radon/masking.py", "radon/solve.py",
                "launch/serve.py",
                "core/distributed.py", "launch/mesh.py",
                "launch/service.py", "data/synthetic.py",
                "configs/radon_251.py",
                "checkpoint/store.py", "launch/errors.py",
                "launch/faults.py", "launch/router.py", "launch/pool.py",
                "launch/supervisor.py", "radon/healthz.py",
                "radon/selfcheck.py",
                "models/config.py", "models/layers.py",
                "models/attention.py", "models/rglru.py", "models/ssm.py",
                "models/moe.py", "models/blocks.py", "models/lm.py",
                "models/convert.py", "configs/registry.py",
                "parallel/sharding.py", "tree.py",
                "optim/__init__.py", "optim/adamw.py", "optim/compress.py",
                "runtime/__init__.py", "runtime/trainer.py",
                "data/pipeline.py", "launch/train.py", "launch/steps.py",
                "launch/shapes.py", "core/pareto.py", "launch/roofline.py",
                "launch/hlo_cost.py", "launch/dryrun.py",
                "parallel/tensor.py"):
        assert mod in rel, mod
    for src in ("sfdprt.cu", "pipeline.cu", "stream.cu"):
        assert os.path.isfile(os.path.join(PORT, "kernels", "csrc", src))
    from repro_torch.configs import ARCH_IDS
    for arch in ARCH_IDS:
        assert f"configs/{arch}.py" in rel, arch


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    assert _forbidden_imports(path) == []


def test_scanner_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import dprt\n"
                   "from repro_torch import radon\nfrom . import ops\n"
                   "def f():\n    import repro.kernels\n")
    assert _forbidden_imports(str(src)) == [
        "line 1: jax.numpy", "line 2: repro.core", "line 6: repro.kernels"]


def test_importing_the_dry_run_opens_no_process_group():
    """``launch/dryrun.py`` opens its fake world inside ``run_cell`` /
    ``main``, never at import (the reference's sets ``XLA_FLAGS`` at
    import)."""
    import importlib
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    importlib.reload(dryrun)
    assert not dist.is_initialized()
