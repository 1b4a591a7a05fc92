"""Core DPRT library of the port: primitives, geometry, plans, exact
convolution and the DPRT-based DFT.

``dprt`` here is the submodule :mod:`repro_torch.core.dprt`, which is
callable as the legacy ``dprt(f, method=...)`` shim: the reference's
``repro.core.dprt`` is that function (shadowing its own submodule), and
a callable module keeps both ``repro_torch.core.dprt(f)`` and
``import repro_torch.core.dprt as m`` working."""
from . import dprt
from .dprt import (idprt, dprt_batched, idprt_batched, skew_sum,
                   strip_partial, align_partial, is_prime,
                   next_prime, accum_dtype_for, forward_sum_dtype_for,
                   float_dtype_for,
                   int32_accum_exact, dprt_oracle_np, idprt_oracle_np)
from .geometry import Geometry, normalize_geometry
from .plan import (Backend, RadonPlan, available_backends,
                   backend_capabilities, get_backend, get_plan,
                   plan_cache_clear, plan_cache_discard, plan_cache_entries,
                   plan_cache_info, plan_from_description, register_backend,
                   select_backend, set_plan_cache_maxsize)
from .conv import (circ_conv2d_dprt, circ_conv2d_direct, circ_conv2d_fft,
                   linear_conv2d_dprt, linear_conv2d_direct,
                   circ_conv1d_exact, prime_vs_pow2_padding)
from .dft import dft2_via_dprt, dft2_via_dprt_batched, dft2_reference
from . import pareto

__all__ = [
    "dprt", "idprt", "dprt_batched", "idprt_batched",
    "skew_sum", "strip_partial", "align_partial", "is_prime", "next_prime",
    "accum_dtype_for", "forward_sum_dtype_for", "float_dtype_for",
    "int32_accum_exact",
    "dprt_oracle_np", "idprt_oracle_np",
    "Geometry", "normalize_geometry",
    "Backend", "RadonPlan", "available_backends", "backend_capabilities",
    "get_backend", "get_plan", "plan_cache_clear", "plan_cache_discard",
    "plan_cache_entries", "plan_cache_info", "plan_from_description",
    "register_backend", "select_backend", "set_plan_cache_maxsize",
    "circ_conv2d_dprt", "circ_conv2d_direct", "circ_conv2d_fft",
    "linear_conv2d_dprt", "linear_conv2d_direct", "circ_conv1d_exact",
    "prime_vs_pow2_padding", "dft2_via_dprt", "dft2_via_dprt_batched",
    "dft2_reference", "pareto",
]
