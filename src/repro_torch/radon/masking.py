"""Masked / weighted DPRT operators: the partial-data measurement model.

The port of :mod:`repro.radon.masking`.  A detector that drops whole
projection directions, has dead rows or weighs its samples measures

    M = D A,   D = diag(mask * weight)  on the (P+1, P) projection grid

with ``A`` the exact forward DPRT of a cached plan.  :class:`MaskedDPRT`
is the measurement operator :mod:`repro_torch.radon.solve` inverts:

* ``m(f)``   -- masked projections ``d * A f`` (float arithmetic);
* ``m.T``    -- the exact adjoint ``A^T D`` (``m.T.T`` applies ``D A``
  again), equal to ``m.as_matrix().T`` entry for entry;
* ``m.normal_apply(x)`` -- ``M^T M x`` as ONE fused pipeline call
  (one K2 ``mul`` launch on the ``cuda`` backend) plus a column-sum
  term -- the inner loop of every iterative solver;
* ``m.normal_rhs(b)``   -- ``M^T (d * b) = A^T (d^2 * b)``.

The launch-count identity: the exact adjoint satisfies, entrywise,

    A^T r = P * B r + S(r) * 1,     S(r) = sum_d r(0, d),

with ``B`` the exact inverse (true divide by P on float plans), so

    M^T M x = P * [inv . (d^2 *) . fwd](x) + S(d^2 * A x) * 1

whose bracket is the fused ``pipeline("mul")`` and whose scalar needs
only the column sums of ``x`` (row 0 of ``A x`` is the column-sum
projection).

Arithmetic promotes to :func:`repro_torch.core.dprt.float_dtype_for` of
the image dtype on the float sibling of the operator's plan (same
geometry, backend and knobs).  ``d`` lives on the device of the first
mask or weight given (``device=``, default the card, when there is
none); a part on another device raises rather than being copied.
"""
from __future__ import annotations

import torch

from ..core.dprt import as_dtype, dtype_name, float_dtype_for
from ..core.plan import get_plan

__all__ = ["direction_mask", "MaskedDPRT"]


def direction_mask(n: int, missing, dtype=torch.float32,
                   device="cuda") -> torch.Tensor:
    """A ``(n+1, n)`` projection-domain mask with whole directions
    removed: row ``m`` of the sinogram is zeroed for every ``m`` in
    ``missing`` (directions ``0..n``; ``n`` is the row-sum direction).
    The complement stays 1, so the mask is a 0/1 diagonal."""
    n = int(n)
    missing = torch.atleast_1d(
        torch.as_tensor(missing, dtype=torch.int64).cpu())
    keep = ~torch.isin(torch.arange(n + 1), missing)
    out = keep[:, None].to(as_dtype(dtype)).expand(n + 1, n)
    return out.contiguous().to(device)


def _float_plan(plan, fdtype):
    """The float-dtype sibling of ``plan``: same geometry, same resolved
    backend and block knobs, float arithmetic.  Plans are cached, so
    this is a dict lookup after the first build."""
    return get_plan(plan.geometry.image_shape, fdtype, plan.method,
                    strip_rows=plan.strip_rows, m_block=plan.m_block,
                    batch_impl=plan.batch_impl, block_rows=plan.block_rows,
                    stream_rows=plan.stream_rows,
                    block_batch=plan.block_batch, mesh=plan.mesh)


def _diagonal(tshape, fdtype, mask, weight, device) -> torch.Tensor:
    """``mask * weight`` broadcast onto the projection grid, on the
    device of the first part given (else ``device``)."""
    parts = [torch.as_tensor(p) for p in (mask, weight) if p is not None]
    if parts:
        device = parts[0].device
    d = torch.ones(tshape[-2:], dtype=fdtype, device=device)
    for part in parts:
        if part.device != d.device:
            raise ValueError(
                f"mask/weight on {part.device} does not match the "
                f"diagonal's device {d.device}; move it explicitly")
        try:
            d = d * part.to(fdtype)
        except RuntimeError as e:
            raise ValueError(
                f"mask/weight must broadcast to {tshape}, got shape "
                f"{tuple(part.shape)}") from e
    if tuple(d.shape[-2:]) != tuple(tshape[-2:]) or d.ndim > len(tshape):
        raise ValueError(f"mask/weight must broadcast to {tshape}, got "
                         f"diagonal of shape {tuple(d.shape)}")
    if d.ndim == len(tshape) == 3 and d.shape[0] != tshape[0]:
        raise ValueError(f"batched mask/weight {tuple(d.shape)} does not "
                         f"match plan batch {tshape[0]}")
    return d.contiguous()


class MaskedDPRT:
    """``M = diag(mask * weight) . A``: the masked/weighted forward DPRT.

    ``op`` is a forward :class:`repro_torch.radon.RadonOperator` (any
    geometry, any dtype).  ``mask`` and ``weight`` broadcast against the
    ``(…, P+1, P)`` projection grid and combine into one diagonal ``d``;
    either may be ``None``.  A 3-D ``d`` gives per-image masks for a
    batched plan.  ``device`` places an all-ones ``d`` when neither is
    given.

    The operator surface matches :class:`RadonOperator` where it
    matters: ``shape_in`` / ``shape_out`` / ``dtype_in``, ``__call__``
    (differentiable), ``.T`` (exact adjoint, an involution),
    ``as_matrix()`` for small-N tests, and ``@`` composition.
    """

    __slots__ = ("plan", "d", "fdtype", "_adjoint")

    def __init__(self, op, mask=None, weight=None, *, device="cuda",
                 _plan=None, _d=None, _adjoint: bool = False):
        if _plan is not None:          # internal: pre-built view
            plan, fdtype, d = _plan, as_dtype(_plan.dtype_name), _d
        else:
            plan = getattr(op, "plan", None)
            if plan is None or getattr(op, "kind", "forward") != "forward":
                raise ValueError(
                    f"MaskedDPRT wraps a forward RadonOperator, got {op!r}")
            fdtype = float_dtype_for(op.dtype)
            plan = _float_plan(plan, fdtype)
            d = _diagonal(plan.geometry.transform_shape, fdtype, mask,
                          weight, device)
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "d", d)
        object.__setattr__(self, "fdtype", fdtype)
        object.__setattr__(self, "_adjoint", bool(_adjoint))

    def __setattr__(self, name, value):
        raise AttributeError("MaskedDPRT is immutable")

    # -- shapes / dtypes ---------------------------------------------------
    @property
    def shape_in(self):
        g = self.plan.geometry
        return g.transform_shape if self._adjoint else g.image_shape

    @property
    def shape_out(self):
        g = self.plan.geometry
        return g.image_shape if self._adjoint else g.transform_shape

    @property
    def dtype_in(self) -> torch.dtype:
        return self.fdtype

    dtype_out = dtype_in

    @property
    def is_identity_diagonal(self) -> bool:
        """True when ``d`` is exactly all-ones -- the unmasked case the
        Sherman-Morrison fast path of :mod:`repro_torch.radon.solve`
        owns."""
        return bool((self.d == 1).all())

    def _check_device(self, x: torch.Tensor) -> None:
        if x.device != self.d.device:
            raise ValueError(f"input on device {x.device}, but the "
                             f"mask/weight diagonal lives on {self.d.device}")

    # -- application -------------------------------------------------------
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from .autodiff import apply_plan
        x = torch.as_tensor(x)
        self._check_device(x)
        x = x.to(self.fdtype)
        if self._adjoint:
            return apply_plan(self.plan, "adjoint", self.d * x)
        return self.d * apply_plan(self.plan, "forward", x)

    # -- algebra -----------------------------------------------------------
    @property
    def T(self) -> "MaskedDPRT":
        """The exact adjoint ``(D A)^T = A^T D`` (and back: ``m.T.T``
        applies ``D A`` again)."""
        return MaskedDPRT(None, _plan=self.plan, _d=self.d,
                          _adjoint=not self._adjoint)

    def __matmul__(self, other):
        from .operators import _compose
        return _compose(self, other)

    def __rmatmul__(self, other):
        from .operators import _compose
        return _compose(other, self)

    # -- normal equations (the solver inner loop) --------------------------
    def _srow(self) -> torch.Tensor:
        """Row 0 of ``d^2`` restricted to the W true columns: the only
        part of ``d^2 * A x`` that feeds ``S`` (row 0 of ``A x`` is the
        column-sum projection; embedded columns >= W sum zeros)."""
        w = self.plan.geometry.image_shape[-1]
        return (self.d * self.d)[..., 0, :w]

    def normal_apply(self, x: torch.Tensor) -> torch.Tensor:
        """``M^T M x`` in one fused pipeline call + a column-sum term:
        ``P * pipeline(x, "mul", d^2) + S(d^2 * A x) * 1`` (module
        docstring).  Raw-plan arithmetic: not differentiable."""
        self._check_device(x)
        p = self.plan.geometry.prime
        y = self.plan.pipeline(x, "mul", self.d * self.d)
        s = (self._srow() * x.sum(-2)).sum(-1)
        return p * y + s[..., None, None]

    def normal_rhs(self, b: torch.Tensor) -> torch.Tensor:
        """``M^T (d * b) = A^T (d^2 * b)``: the normal-equation right-
        hand side, via ``A^T r = P * B r + S(r) * 1``."""
        self._check_device(b)
        r = (self.d * self.d) * b.to(self.fdtype)
        p = self.plan.geometry.prime
        s = r[..., 0, :].sum(-1)
        return p * self.plan.inverse(r) + s[..., None, None]

    # -- introspection -----------------------------------------------------
    def as_matrix(self, device=None) -> torch.Tensor:
        """Dense (out_size, in_size) matrix, one basis vector per input
        element (small N; tests).  ``device`` defaults to ``d``'s."""
        device = self.d.device if device is None else torch.device(device)
        size_in = 1
        for s in self.shape_in:
            size_in *= s
        basis = torch.eye(size_in, dtype=self.fdtype, device=device)
        cols = [self(e.reshape(self.shape_in)).reshape(-1) for e in basis]
        return torch.stack(cols, dim=1)

    def __repr__(self) -> str:
        tag = "adjoint " if self._adjoint else ""
        return (f"MaskedDPRT({tag}{self.shape_in}->{self.shape_out}, "
                f"{dtype_name(self.fdtype)}, method={self.plan.method!r})")

    def __eq__(self, other):
        return (isinstance(other, MaskedDPRT)
                and self.plan == other.plan
                and self._adjoint == other._adjoint
                and self.d is other.d)

    def __hash__(self):
        return hash((self.plan, self._adjoint, id(self.d)))
