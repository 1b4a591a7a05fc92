"""``repro_torch.radon`` -- the public operator API of the port.

    import torch
    from repro_torch import radon

    op = radon.DPRT((256, 251, 251), torch.int32)   # auto: the cuda kernel
    r = op(img)                                     # (…, P+1, P) projections
    f = op.inverse(r)                               # bit-exact reconstruction
    y = op.T(w)                                     # exact adjoint

    conv = radon.Conv2D(img.shape, torch.ones(3, 3, dtype=torch.int32))
    y = conv(img)                                   # exact, one K2 call
    filt = op.inverse @ radon.ProjectionFilter(w) @ op   # fused: one K2 call

    mask = radon.direction_mask(251, [3, 40])       # two directions lost
    res = radon.solve(op, mask * r.float(), mask=mask)   # masked CG
    res.image, res.iterations                       # one K2 call per iteration

    with radon.config(method="horner"):
        ...                                         # ambient knob defaults

Exports what the port has so far: the DPRT operators, the
projection-domain fusion surface (``Conv2D``, ``ProjectionFilter``,
``FusedProjectionPipeline``, ``pipeline_apply``), the reconstruction
subsystem (``solve``, ``SolveResult``, ``METHODS``, ``MaskedDPRT``,
``direction_mask``, ``ReconstructionOperator``, ``solve_operator``:
Sherman-Morrison for unmasked data, CG / LSQR / Landweber otherwise,
each CG iteration one fused ``mul`` pipeline call), ambient config
scopes, build accounting, the plan layer, and the AOT surface
(``op.lower`` / ``compile`` / ``cache_token`` / ``export_executable`` /
``import_executable``, :class:`Executable`, the in-process cache and
:class:`PersistentAOTCache` on disk, :func:`aot_fingerprint`).
"""
from ..core.plan import (Backend, RadonPlan, available_backends,
                         backend_capabilities, get_backend, get_plan,
                         plan_cache_clear, plan_cache_discard,
                         plan_cache_entries, plan_cache_info,
                         plan_from_description, register_backend,
                         select_backend, set_plan_cache_maxsize)

from .ambient import CONFIG_KEYS, config, current_config
from .autodiff import (RetraceError, reset_trace_counts, retrace_guard,
                       trace_count, trace_counts)
from .fusion import flip_image, flip_lanes, pipeline_apply
from .masking import MaskedDPRT, direction_mask
from .operators import (DPRT, CompositeOperator, Conv2D, Executable,
                        FusedProjectionPipeline, Lowered, PersistentAOTCache,
                        ProjectionFilter, RadonOperator, aot_cache_clear,
                        aot_cache_info, aot_fingerprint,
                        conv2d_from_description, operator_for,
                        projection_filter_from_numpy)
from .solve import (METHODS, ReconstructionOperator, SolveResult, solve,
                    solve_operator)

__all__ = [
    "DPRT", "Conv2D", "ProjectionFilter", "FusedProjectionPipeline",
    "RadonOperator", "CompositeOperator", "operator_for",
    "conv2d_from_description", "projection_filter_from_numpy",
    "Executable", "Lowered", "aot_cache_info", "aot_cache_clear",
    "PersistentAOTCache", "aot_fingerprint",
    "pipeline_apply", "flip_image", "flip_lanes",
    # reconstruction subsystem
    "solve", "SolveResult", "METHODS", "MaskedDPRT", "direction_mask",
    "ReconstructionOperator", "solve_operator",
    "config", "current_config", "CONFIG_KEYS",
    "retrace_guard", "trace_count", "trace_counts", "reset_trace_counts",
    "RetraceError",
    "Backend", "RadonPlan", "available_backends", "backend_capabilities",
    "get_backend", "get_plan", "plan_cache_clear", "plan_cache_discard",
    "plan_cache_entries", "plan_cache_info", "plan_from_description",
    "register_backend", "select_backend", "set_plan_cache_maxsize",
]
