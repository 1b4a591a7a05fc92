"""``repro_torch.radon`` -- the public operator API of the port.

    import torch
    from repro_torch import radon

    op = radon.DPRT((256, 251, 251), torch.int32)   # auto: the cuda kernel
    r = op(img)                                     # (…, P+1, P) projections
    f = op.inverse(r)                               # bit-exact reconstruction
    y = op.T(w)                                     # exact adjoint

    with radon.config(method="horner"):
        ...                                         # ambient knob defaults

Exports only what the port has so far: the DPRT operators, ambient
config scopes, retrace accounting and the plan layer.
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
from .operators import DPRT, CompositeOperator, RadonOperator, operator_for

__all__ = [
    "DPRT", "RadonOperator", "CompositeOperator", "operator_for",
    "config", "current_config", "CONFIG_KEYS",
    "retrace_guard", "trace_count", "trace_counts", "reset_trace_counts",
    "RetraceError",
    "Backend", "RadonPlan", "available_backends", "backend_capabilities",
    "get_backend", "get_plan", "plan_cache_clear", "plan_cache_discard",
    "plan_cache_entries", "plan_cache_info", "plan_from_description",
    "register_backend", "select_backend", "set_plan_cache_maxsize",
]
