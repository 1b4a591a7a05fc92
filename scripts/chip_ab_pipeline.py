#!/usr/bin/env python3
"""Time the port's pipeline kernels of several trees in turns on one card.

    python3 scripts/chip_ab_pipeline.py [--sass DIR] TREE [TREE ...]

Each TREE is the root of a checkout of the repository: for example a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists, and ``.``.  Give them in turns (``build/parent .
. build/parent``): two versions are compared only within one run on
one card.  For each TREE, in a process of its own, the script builds
that tree's kernels (into its own ``build/``) and times, by CUDA events
(median of 40 runs), K1's forward, K2 and K3 for conv / mul / none at
radon_251 (N = 251, B = 256 int32 phantoms, the table's m_block; K3 on
all 252 directions, world size 1), then prints one line ``AB {json}``.
``--sass DIR`` also writes the int32 K = 8 instantiations of each
tree's ``pipeline`` library (``cuobjdump -sass``) to DIR.  The last
line is the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPS = 40


def one(tree: str, sass_dir: str | None) -> None:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(HERE.parent))
    import numpy as np
    import torch
    from chip_smoke import cuda_ms
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import _build
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels.tuning import (pallas_block_spec,
                                            pipeline_block_spec)

    if not _build.CSRC.is_relative_to(root):
        raise RuntimeError(f"imported the kernels of {_build.CSRC}, not of "
                           f"{root}")
    _build.build()
    n, b = 251, 256
    dev = torch.device("cuda")
    f = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    kern = torch.zeros((1, n, n), dtype=torch.int32, device=dev)
    kern[:, :3, :3] = 1
    rg = S.sfdprt_plain(kern, sign=1, mode="forward")
    w = torch.from_numpy(np.random.default_rng(5).integers(
        -7, 8, (1, n + 1, n)).astype(np.int32)).to(dev)
    rows = S.sfdprt_plain(f, sign=1, mode="forward")
    torch.cuda.synchronize()
    h, mb1 = pallas_block_spec(n)
    mb, grp = pipeline_block_spec(n)
    out = {"tree": tree,
           "k1_forward": cuda_ms(lambda: S.dprt_raw(f, strip_rows=h,
                                                     m_block=mb1), reps=REPS)}
    for op, opd in (("conv", rg), ("mul", w), ("none", None)):
        out[f"k2_{op}"] = cuda_ms(lambda: P.pipeline_raw(
            f, opd, op=op, operand_form="proj", m_block=mb, group=grp),
            reps=REPS)
        out[f"k3_{op}"] = cuda_ms(lambda: P.pipeline_tail_raw(
            rows, opd, op=op, row_offset=0, m_block=mb), reps=REPS)
    print("AB " + json.dumps(out), flush=True)
    if sass_dir:
        from torch.utils.cpp_extension import CUDA_HOME
        text = subprocess.run(
            [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
             str(_build._lib_path("pipeline"))], capture_output=True,
            text=True, timeout=300, check=True).stdout
        parts = re.split(r"(?=\n\s*Function : )", text)
        name = re.sub(r"\W+", "_", tree).strip("_") or "tree"
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        (Path(sass_dir) / f"{name}_pipeline.sass").write_text("".join(
            p for p in parts if "IiLi8E" in p[:400]))


def main(argv: list) -> int:
    if argv[:1] == ["--one"]:
        one(argv[1], argv[2] if len(argv) > 2 else None)
        return 0
    sass_dir = None
    if argv[:1] == ["--sass"]:
        sass_dir, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for i, tree in enumerate(argv):
        # the SASS of each tree once, from its first turn
        extra = [sass_dir] if sass_dir and tree not in argv[:i] else []
        rc = subprocess.run([sys.executable, __file__, "--one", tree,
                             *extra]).returncode
        if rc != 0:
            return rc
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
