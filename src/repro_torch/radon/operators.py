"""First-class linear-operator objects over cached transform plans.

The port of the transform half of :mod:`repro.radon.operators`.
``op = radon.DPRT(shape, dtype)`` builds (or fetches: plans are cached)
the forward DPRT operator for one input geometry:

    op(f)            # apply: (…, H, W) -> (…, P+1, P), differentiable
    op.inverse       # the exact inverse transform (crops the embedding)
    op.T             # the exact adjoint -- A^T, NOT the inverse
    op.inverse.T     # adjoint of the inverse == (A^T)^-1
    op2 @ op1        # composition (applied right-to-left)
    op.compile(dev)  # build the kernels and make one warm call
    op.as_matrix()   # dense (out_size, in_size) matrix (small N; tests)

Operators are device-agnostic: they run on the device of the tensor
they are given.  Every application routes through
:mod:`repro_torch.radon.autodiff`, so gradients are exact for every
backend.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.dprt import accum_dtype_for, as_dtype, dtype_name
from ..core.plan import RadonPlan, get_plan
from . import ambient
from .autodiff import INVERSE_OF, TRANSPOSE_OF, apply_plan, trace_count

__all__ = ["DPRT", "RadonOperator", "CompositeOperator", "operator_for"]


class RadonOperator:
    """One linear datapath of a :class:`~repro_torch.core.plan.RadonPlan`.

    ``kind`` is one of ``forward`` / ``inverse`` / ``adjoint`` /
    ``inverse_adjoint``; ``dtype`` is the *image* dtype the operator was
    declared for (transform-domain inputs/outputs use its accumulator
    dtype, as the transforms themselves do).
    """

    __slots__ = ("plan", "kind", "dtype")

    def __init__(self, plan: RadonPlan, kind: str, dtype):
        if kind not in TRANSPOSE_OF:
            raise ValueError(f"unknown operator kind {kind!r}")
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "dtype", as_dtype(dtype))

    def __setattr__(self, name, value):
        raise AttributeError("RadonOperator is immutable")

    # -- shapes / dtypes ---------------------------------------------------
    @property
    def _image_side(self) -> bool:
        """True when the INPUT lives in image space (H, W)."""
        return self.kind in ("forward", "inverse_adjoint")

    @property
    def shape_in(self) -> Tuple[int, ...]:
        g = self.plan.geometry
        return g.image_shape if self._image_side else g.transform_shape

    @property
    def shape_out(self) -> Tuple[int, ...]:
        g = self.plan.geometry
        return g.transform_shape if self._image_side else g.image_shape

    @property
    def dtype_in(self) -> torch.dtype:
        # forward consumes raw images; every other datapath consumes
        # transform-domain / cotangent values in the accumulator dtype
        if self.kind == "forward":
            return self.dtype
        return accum_dtype_for(self.dtype, self.plan.geometry.prime)

    @property
    def dtype_out(self) -> torch.dtype:
        return accum_dtype_for(self.dtype, self.plan.geometry.prime)

    # -- application -------------------------------------------------------
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return apply_plan(self.plan, self.kind, x)

    # -- algebra -----------------------------------------------------------
    @property
    def T(self) -> "RadonOperator":
        """The exact adjoint: ``<op(x), y> == <x, op.T(y)>``."""
        return RadonOperator(self.plan, TRANSPOSE_OF[self.kind], self.dtype)

    @property
    def inverse(self) -> "RadonOperator":
        """The exact inverse transform (bit-exact round trip on ints)."""
        return RadonOperator(self.plan, INVERSE_OF[self.kind], self.dtype)

    def __matmul__(self, other):
        return _compose(self, other)

    # -- warm-up -----------------------------------------------------------
    def compile(self, device="cuda") -> "RadonOperator":
        """Build what this operator runs on ``device`` -- the plan is
        already built; this compiles the CUDA kernels (once per process)
        and makes one warm call on zeros -- and return the operator,
        ready for traffic that rebuilds nothing."""
        device = torch.device(device)
        x = torch.zeros(self.shape_in, dtype=self.dtype_in, device=device)
        self(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return self

    # -- introspection -----------------------------------------------------
    @property
    def trace_count(self) -> int:
        """Builds of this operator's plan so far (1 once it exists)."""
        return trace_count(self.plan)

    def as_matrix(self, device="cuda") -> torch.Tensor:
        """Dense (out_size, in_size) matrix of this linear map, one basis
        vector per input element -- O(P^4) memory, small primes only."""
        size_in = 1
        for s in self.shape_in:
            size_in *= s
        basis = torch.eye(size_in, dtype=self.dtype_in, device=device)
        cols = [self(e.reshape(self.shape_in)).reshape(-1) for e in basis]
        return torch.stack(cols, dim=1)

    def describe(self) -> dict:
        d = dict(self.plan.describe())
        d.update(kind=self.kind, dtype=dtype_name(self.dtype),
                 shape_in=self.shape_in, shape_out=self.shape_out)
        return d

    def __repr__(self) -> str:
        return (f"RadonOperator({self.kind}, {self.shape_in}->"
                f"{self.shape_out}, {self.dtype}, "
                f"method={self.plan.method!r})")

    def __eq__(self, other):
        return (isinstance(other, RadonOperator)
                and self.plan == other.plan and self.kind == other.kind
                and self.dtype == other.dtype)

    def __hash__(self):
        return hash((self.plan, self.kind, self.dtype))


def _compose(left, right):
    """``left @ right``: flatten into one CompositeOperator."""
    if not (_is_operator_like(left) and _is_operator_like(right)):
        return NotImplemented
    lops = left.ops if isinstance(left, CompositeOperator) else (left,)
    rops = right.ops if isinstance(right, CompositeOperator) else (right,)
    return CompositeOperator(lops + rops)


def _is_operator_like(x) -> bool:
    return callable(x) and hasattr(x, "shape_in") and hasattr(x, "shape_out")


class CompositeOperator:
    """Right-to-left composition of operators: ``(g @ f)(x) == g(f(x))``.

    Supports the same algebra (``.T`` reverses and transposes,
    ``.inverse`` reverses and inverts); shape chaining is validated at
    construction.
    """

    __slots__ = ("ops",)

    def __init__(self, ops: Tuple):
        if not ops:
            raise ValueError("CompositeOperator needs at least one operator")
        ops = tuple(ops)
        for outer, inner in zip(ops[:-1], ops[1:]):
            if (outer.shape_in is not None and inner.shape_out is not None
                    and outer.shape_in != inner.shape_out):
                raise ValueError(
                    f"cannot compose {outer!r} after {inner!r}: "
                    f"{inner.shape_out} does not feed {outer.shape_in}")
        object.__setattr__(self, "ops", ops)

    def __setattr__(self, name, value):
        raise AttributeError("CompositeOperator is immutable")

    @property
    def shape_in(self):
        return self.ops[-1].shape_in

    @property
    def shape_out(self):
        return self.ops[0].shape_out

    @property
    def dtype_in(self):
        return self.ops[-1].dtype_in

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for op in reversed(self.ops):
            x = op(x)
        return x

    @property
    def T(self) -> "CompositeOperator":
        return CompositeOperator(tuple(op.T for op in reversed(self.ops)))

    @property
    def inverse(self) -> "CompositeOperator":
        return CompositeOperator(
            tuple(op.inverse for op in reversed(self.ops)))

    def __matmul__(self, other):
        return _compose(self, other)

    def as_matrix(self, device="cuda") -> torch.Tensor:
        mats = [op.as_matrix(device) for op in self.ops]
        out = mats[-1]
        for m in reversed(mats[:-1]):
            out = m.to(out.dtype) @ out
        return out

    def __repr__(self) -> str:
        return " @ ".join(repr(op) for op in self.ops)

    def __eq__(self, other):
        return (isinstance(other, CompositeOperator)
                and self.ops == other.ops)

    def __hash__(self):
        return hash(self.ops)


def DPRT(shape, dtype=torch.int32, method: Optional[str] = None, *,
         strip_rows: Optional[int] = None,
         m_block: Optional[int] = None,
         batch_impl: Optional[str] = None,
         block_rows: Optional[int] = None,
         stream_rows: Optional[int] = None,
         block_batch: Optional[int] = None,
         mesh=None) -> RadonOperator:
    """The forward DPRT operator for one input geometry.

    ``shape`` is ``(H, W)`` or ``(B, H, W)`` -- any size; non-prime
    geometries are zero-embedded into the next prime and ``op.inverse``
    crops back.  Knobs left unset resolve against the ambient
    :func:`repro_torch.radon.config` scope, then ``method="auto"`` (the
    ``cuda`` kernel backend for int/float images).  ``stream_rows`` and
    ``mesh`` are not ported yet and raise ``NotImplementedError``.
    """
    plan = get_plan(
        tuple(int(s) for s in shape), dtype,
        ambient.resolve("method", method, "auto"),
        strip_rows=ambient.resolve("strip_rows", strip_rows),
        m_block=ambient.resolve("m_block", m_block),
        batch_impl=ambient.resolve("batch_impl", batch_impl, "auto"),
        block_rows=ambient.resolve("block_rows", block_rows),
        stream_rows=ambient.resolve("stream_rows", stream_rows),
        block_batch=ambient.resolve("block_batch", block_batch),
        mesh=ambient.resolve("mesh", mesh))
    return RadonOperator(plan, "forward", dtype)


def operator_for(shape, dtype, knobs: tuple) -> RadonOperator:
    """The cached forward operator for one geometry from an
    :func:`repro_torch.radon.ambient.snapshot_knobs` tuple."""
    return DPRT(shape, dtype, **ambient.knobs_kwargs(knobs))
