"""Hand-written Hopper kernels for the DPRT hot spot.

K1, the fused batched SFDPRT kernel, lives in ``csrc/sfdprt.cu`` with
its launcher and plain version in :mod:`.sfdprt`; K2, the fused
projection-domain pipeline, and K3, its mesh tail, in
``csrc/pipeline.cu`` with :mod:`.pipeline`; K4/K5, the streamed kernel
of the giant-N path, in ``csrc/stream.cu`` with :mod:`.stream`.  :mod:`.ops` wraps them with
block resolution (:mod:`.tuning`) and is what the plan's ``cuda``
backend dispatches to, and it also carries the reference's names
(``dprt_pallas``, ``idprt_pallas``, ``skew_sum_pallas``,
``skew_sum_pallas_strip``, ``projection_pipeline_pallas``,
``pipeline_tail_pallas``), so code written against ``repro.kernels``
runs here; the reference's TPU-only ``roll_rows_ladder_spec`` does not
carry over.  :mod:`._build` compiles the CUDA sources at first use.
"""
from .ops import (dprt_cuda, dprt_cuda_strip, dprt_pallas, idprt_cuda,
                  idprt_pallas, pipeline_tail_cuda, pipeline_tail_pallas,
                  projection_pipeline_cuda, projection_pipeline_pallas,
                  skew_sum_cuda, skew_sum_cuda_strip, skew_sum_pallas,
                  skew_sum_pallas_strip)
from .ref import dprt_ref, idprt_ref, skew_sum_ref
from .sfdprt import isfdprt_core
from .stream import stream_plain, stream_raw
from .tuning import (PALLAS_TUNE, PIPELINE_TUNE, pallas_block_spec,
                     pipeline_block_spec, resolve_blocks,
                     resolve_pipeline_blocks, stream_tile)

__all__ = ["dprt_cuda", "idprt_cuda", "skew_sum_cuda",
           "skew_sum_cuda_strip", "dprt_cuda_strip", "isfdprt_core",
           "projection_pipeline_cuda", "pipeline_tail_cuda",
           "dprt_pallas", "idprt_pallas", "skew_sum_pallas",
           "skew_sum_pallas_strip", "projection_pipeline_pallas",
           "pipeline_tail_pallas",
           "dprt_ref", "idprt_ref", "skew_sum_ref",
           "stream_raw", "stream_plain", "stream_tile",
           "PALLAS_TUNE", "pallas_block_spec", "resolve_blocks",
           "PIPELINE_TUNE", "pipeline_block_spec",
           "resolve_pipeline_blocks"]
