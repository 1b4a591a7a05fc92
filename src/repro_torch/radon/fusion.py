"""Differentiable projection-pipeline appliers (the fused conv/filter path).

The port of :mod:`repro.radon.fusion`.  :meth:`repro_torch.core.plan.
RadonPlan.pipeline` runs ``forward -> per-direction op -> inverse`` as
one K2 call on capable backends, a kernel autograd cannot see into.
The *operation* is differentiable all the same: it is **bilinear** in
the image and the operand, so each argument's gradient is an exact
transpose built from the same registry:

* w.r.t. the image ``f``: circular convolution transposes to circular
  *correlation* -- the same fused pipeline with the flipped operand
  (``flip(g)[x] = g[<-x>]``; in the projection domain a lane flip,
  since ``R_{flip(g)}(m, d) = R_g(m, <-d>_N)``).  ``"mul"`` transposes
  to ``adjoint(w * inverse_adjoint(ct))`` over the plan's datapaths.
* w.r.t. the operand: for an operand image, commutativity makes it the
  flipped-image pipeline again; the projection/weight forms are
  per-direction correlations against ``forward(f)`` around
  ``inverse_adjoint(ct)``.  An operand shared across a batched plan
  sums its cotangent over the batch.

So the backward runs K2 and K1 and needs no kernel of its own.  Each
(plan, op) gets one :class:`torch.autograd.Function`, created on first
use in :mod:`repro_torch.radon.autodiff`'s per-plan store and counted
as a ``"pipeline:<op>"`` build, so
:func:`~repro_torch.radon.autodiff.retrace_guard` covers it; the
appliers drop with plan-cache evictions.  A call that needs no gradient
runs the plan directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from .autodiff import apply_plan, plan_applier

__all__ = ["pipeline_apply", "pipeline_function", "flip_image", "flip_lanes"]


def flip_image(g: torch.Tensor) -> torch.Tensor:
    """Torus flip: out[..., x, y] = g[..., <-x>_H, <-y>_W]."""
    return torch.roll(torch.flip(g, (-2, -1)), (1, 1), (-2, -1))


def flip_lanes(r: torch.Tensor) -> torch.Tensor:
    """Lane flip: out[..., m, d] = r[..., m, <-d>_N] -- the projection-
    domain image of :func:`flip_image`."""
    return torch.roll(torch.flip(r, (-1,)), 1, -1)


def _is_image_form(plan, wshape) -> bool:
    p = plan.geometry.prime
    return tuple(wshape[-2:]) == (p, p)


def _sum_to_operand(ct_w: torch.Tensor, wshape, wdtype) -> torch.Tensor:
    """An operand shared across a batched plan accumulates its cotangent
    over the batch."""
    while ct_w.ndim > len(wshape):
        ct_w = ct_w.sum(0)
    if ct_w.ndim == 3 and wshape[0] == 1 and ct_w.shape[0] != 1:
        ct_w = ct_w.sum(0, keepdim=True)
    return ct_w.to(wdtype)


def _transpose_f(plan, op: str, w, ct: torch.Tensor) -> torch.Tensor:
    """ct_f = (d pipeline / d f)^T ct, built from registry datapaths."""
    if op == "conv":
        flip = flip_image(w) if _is_image_form(plan, w.shape) \
            else flip_lanes(w)
        out = pipeline_apply(plan, ct, "conv", flip.to(ct.dtype))
    elif op == "mul":
        out = apply_plan(plan, "adjoint",
                         w.to(ct.dtype)
                         * apply_plan(plan, "inverse_adjoint", ct))
    else:  # "none": (B A)^T = A^T B^T
        out = apply_plan(plan, "adjoint",
                         apply_plan(plan, "inverse_adjoint", ct))
    return out.to(ct.dtype)


def _transpose_w(plan, op: str, f, wshape, wdtype,
                 ct: torch.Tensor) -> torch.Tensor:
    """ct_w = (d pipeline / d operand)^T ct."""
    if op == "conv" and _is_image_form(plan, wshape):
        # commutativity: d/dg (f ** g) is h -> f ** h, whose transpose
        # is the flipped-image pipeline again
        return _sum_to_operand(
            pipeline_apply(plan, ct, "conv", flip_image(f).to(ct.dtype)),
            wshape, wdtype)
    bt = apply_plan(plan, "inverse_adjoint", ct)       # B^T ct, (…, P+1, P)
    rf = apply_plan(plan, "forward", f.to(ct.dtype))
    if op == "mul":
        return _sum_to_operand(rf * bt, wshape, wdtype)
    # conv, projection-form operand: per-direction correlation
    #   ct_rg[m, s] = sum_d (B^T ct)[m, d] * R_f[m, <d - s>]
    from ..core.conv import circ_conv1d_exact
    return _sum_to_operand(circ_conv1d_exact(bt, flip_lanes(rf)),
                           wshape, wdtype)


def _make_function(plan, op: str):
    def forward(ctx, f, w):
        ctx.save_for_backward(f, w)
        return plan.pipeline(f, op, w)

    def backward(ctx, ct):
        f, w = ctx.saved_tensors
        ct = ct.contiguous()
        grad_f = grad_w = None
        if ctx.needs_input_grad[0]:
            grad_f = _transpose_f(plan, op, w, ct)
        if ctx.needs_input_grad[1]:
            grad_w = _transpose_w(plan, op, f, tuple(w.shape), w.dtype, ct)
        return grad_f, grad_w

    return type(f"Pipeline{op.title()}Fn", (torch.autograd.Function,), {
        "__doc__": f"The plan's fused ``{op}`` pipeline; backward applies "
                   f"its exact transposes.",
        "forward": staticmethod(forward),
        "backward": staticmethod(backward),
    })


def pipeline_function(plan, op: str):
    """The differentiable fused-pipeline Function of one (plan, op),
    built (and counted as a ``"pipeline:<op>"`` build) on first use."""
    return plan_applier(plan, f"pipeline:{op}",
                        lambda: _make_function(plan, op))


def pipeline_apply(plan, f: torch.Tensor, op: str = "conv",
                   operand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the fused (or staged-fallback) projection pipeline of ``plan``
    on ``f``: build-counted, and exactly differentiable in both the
    image and the operand."""
    if op not in ("none", "mul", "conv"):
        raise ValueError(f"pipeline op must be none|mul|conv: {op!r}")
    fn = pipeline_function(plan, op)
    needs_grad = f.requires_grad or (operand is not None
                                     and operand.requires_grad)
    if torch.is_grad_enabled() and needs_grad:
        return fn.apply(f, operand)
    return plan.pipeline(f, op, operand)
