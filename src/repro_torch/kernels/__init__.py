"""Hand-written Hopper kernels for the DPRT hot spot.

K1, the fused batched SFDPRT kernel, lives in ``csrc/sfdprt.cu`` with
its launcher and plain version in :mod:`.sfdprt`; :mod:`.ops` wraps it
with block resolution (:mod:`.tuning`) and is what the plan's ``cuda``
backend dispatches to.  :mod:`._build` compiles the CUDA sources at
first use.
"""
from .ops import (dprt_cuda, dprt_cuda_strip, idprt_cuda, skew_sum_cuda,
                  skew_sum_cuda_strip)
from .ref import dprt_ref, idprt_ref, skew_sum_ref
from .sfdprt import isfdprt_core
from .tuning import PALLAS_TUNE, pallas_block_spec, resolve_blocks

__all__ = ["dprt_cuda", "idprt_cuda", "skew_sum_cuda",
           "skew_sum_cuda_strip", "dprt_cuda_strip", "isfdprt_core",
           "dprt_ref", "idprt_ref", "skew_sum_ref",
           "PALLAS_TUNE", "pallas_block_spec", "resolve_blocks"]
