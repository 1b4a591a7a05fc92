"""The port's API health smoke (``python -m repro_torch.radon.selfcheck``)
on the CPU: every registered backend's round trip and gradient, the
``sharded_cuda`` backend (the reference's ``sharded_pallas``) on a
one-rank gloo mesh, fused against staged conv, the reconstruction gate
(Sherman-Morrison exact, masked CG against ``lstsq``), zero rebuilds on
a warm geometry and a compiled executable serving the same bits.  It
passes here with the kernels' plain versions, leaves no process group
behind that it opened, and refuses a card that is not there.
"""
import torch
import torch.distributed as dist

import pytest

from repro_torch.radon import selfcheck


def test_selfcheck_passes_on_cpu(capsys):
    opened_before = dist.is_initialized()
    assert selfcheck.run("cpu") == 0
    out = capsys.readouterr().out
    assert "[selfcheck] PASS" in out and "FAIL" not in out
    for line in ("sharded_cuda: round trip bit-exact",
                 "cuda: fused conv pipeline == staged",
                 "solve: masked-direction CG == dense LS oracle",
                 "AOT compile serves the same bits"):
        assert line in out, line
    assert dist.is_initialized() == opened_before


def test_selfcheck_cli(capsys):
    assert selfcheck.main(["--device", "cpu"]) == 0
    assert "[selfcheck] PASS" in capsys.readouterr().out


def test_selfcheck_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfcheck.run("cuda")
