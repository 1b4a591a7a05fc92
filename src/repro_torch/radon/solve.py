"""Iterative reconstruction over DPRT operators: ``radon.solve``.

The port of :mod:`repro.radon.solve`, with the AOT surface of
:class:`ReconstructionOperator` (``lower`` / ``compile`` /
``cache_token`` / ``export_executable`` / ``import_executable``, as on
the transform operators: :mod:`repro_torch.radon.operators`).
Weighted / partial-data least squares

    min_x || d * (A x - b) ||_2^2,      d = mask * weight

over the exact transforms of a cached plan:

* **Sherman-Morrison** (``method="sherman"``, the ``"auto"`` choice when
  nothing is masked): ``A^T A = P I + 1 1^T`` inverts in closed form,
  ``(P I + 1 1^T)^{-1} y = y/P - sum(y) / (P (P + H W))``, so the
  unmasked solution is one exact inverse (one K1 ``inverse`` launch on
  the ``cuda`` backend) and a rank-1 correction; ``iterations == 0``.
* **CG on the normal equations** (``method="cg"``, the masked default):
  each application of ``M^T M`` is one fused ``pipeline("mul", d^2)``
  call -- one K2 launch -- plus a column-sum term
  (:meth:`repro_torch.radon.masking.MaskedDPRT.normal_apply`);
  ``precond="sherman"`` (the exact unmasked inverse, SPD, no launch) or
  a :class:`~repro_torch.radon.ProjectionFilter` / ``(…, P+1, P)``
  weight array riding the same fused pipeline (a second K2 launch per
  iteration; flexible PCG, convergence heuristic).  Masked normal
  matrices are singular, so CG returns the best iterate it saw and
  freezes a batch element whose residual rebounds 100x above its best
  or whose curvature is lost.
* **LSQR** (Golub-Kahan on ``M = D A``: one K1 forward and one K1
  inverse per iteration) and **Landweber** (``x += tau (M^T b_w - M^T M
  x)``, one K2 launch per iteration, default ``tau = 1 / (max(d)^2 (P +
  H W))``).

The reference's ``lax.while_loop`` bodies are torch loops over tensors
on the operand's device.  Each iteration reads one flag from the host --
``k < maxiter`` and not every batch element converged or stalled -- and
nothing else; every element steps until all stop, and stopped elements
do not move.  The bodies are cached per ``(plan, method, maxiter,
precond kind)`` in :mod:`repro_torch.radon.autodiff`'s per-plan store
and counted as one ``"solve:<method>"`` build, so a warm solve builds
nothing (:func:`repro_torch.radon.retrace_guard`).  :data:`ITERATIONS`
counts the loops' iterations on the host, by loop.

Differentiation: at convergence the solve is the linear map
``b -> G^+ A^T D^2 b`` (``G = M^T M``), so it is a
:class:`torch.autograd.Function` whose backward is its transpose
``ct -> D^2 A G^+ ct`` (another solve, then one forward) and whose
``jvp`` applies the map to the tangent sinogram.  The mask/weight
diagonal and the preconditioner are not differentiable inputs: one that
requires grad raises.  Integer sinograms promote to
:func:`repro_torch.core.dprt.float_dtype_for` before any plan
arithmetic.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from ..core.dprt import dtype_name
from .autodiff import plan_applier
from .masking import MaskedDPRT
from .operators import (DPRT, ProjectionFilter, _AOTSurface, _digest,
                        _knob_token, _plan_record, _topology_token)

__all__ = ["METHODS", "SolveResult", "solve", "solve_operator",
           "ReconstructionOperator", "ITERATIONS", "reset_iteration_counts"]

#: registered solve methods; "auto" resolves to sherman (unmasked) / cg
METHODS = ("sherman", "cg", "lsqr", "landweber")

#: loop iterations since the last reset, by loop (the backward and the
#: jvp of lsqr run the cg loop); counted on the host, where each
#: iteration reads its stop flag
ITERATIONS = {"cg": 0, "lsqr": 0, "landweber": 0}


def reset_iteration_counts() -> None:
    for loop in ITERATIONS:
        ITERATIONS[loop] = 0


class SolveResult(NamedTuple):
    """The reconstruction and its convergence record.

    ``image``: the (…, H, W) solution.  ``residual_norms``: relative
    residual history, shape ``(maxiter + 1, *batch)`` -- entry 0 is 1.0,
    entry k the norm after k iterations scaled by the initial one,
    ``NaN`` past the final iteration (direct methods record
    ``[1.0, final]``).  ``iterations``: int32 count taken.
    ``converged``: scalar bool, every batch element within ``tol``.
    """
    image: torch.Tensor
    residual_norms: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor


def _bdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-batch-element inner product over the trailing two axes."""
    return (u * v).sum((-2, -1))


def _bnorm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_bdot(v, v))


def _bx(s: torch.Tensor) -> torch.Tensor:
    """Broadcast a (*batch,) scalar field over the trailing two axes."""
    return s[..., None, None]


def _safe(x: torch.Tensor) -> torch.Tensor:
    """``x`` where positive, else 1: a divisor that is never 0."""
    return torch.where(x > 0, x, torch.ones_like(x))


def _running(k: int, maxiter: int, stopped: torch.Tensor) -> bool:
    """The loop condition, and the iteration's one read from the host."""
    return k < maxiter and not bool(stopped.all())


def _history(maxiter: int, ref: torch.Tensor) -> torch.Tensor:
    hist = ref.new_full((maxiter + 1,) + tuple(ref.shape), float("nan"))
    hist[0] = (ref > 0).to(ref.dtype)
    return hist


# ---------------------------------------------------------------------------
# the solver bodies (cached per plan, like the pipeline appliers --
# entries drop with plan-cache evictions)
# ---------------------------------------------------------------------------
def _build_solver(plan, method: str, maxiter: int, precond_kind: str):
    """The :class:`torch.autograd.Function` of one (plan, method,
    maxiter, precond kind): ``apply(b, d, g_w, tol, tau)`` returns the
    four fields of a :class:`SolveResult`."""
    geom = plan.geometry
    p = geom.prime
    h, w = geom.image_shape[-2:]
    hw = h * w

    def atd(r):
        """A^T r = P * B r + S(r) * 1 (one inverse launch; see
        :mod:`repro_torch.radon.masking`)."""
        return p * plan.inverse(r) + _bx(r[..., 0, :].sum(-1))

    def normal(x, d2, srow):
        """M^T M x: one fused pipeline call + a column-sum term."""
        y = plan.pipeline(x, "mul", d2)
        return p * y + _bx((srow * x.sum(-2)).sum(-1))

    def sherman_inv(y):
        """(A^T A)^{-1} y = y/P - sum(y) / (P (P + HW)), exact."""
        s = y.sum((-2, -1), keepdim=True)
        return y / p - s / (p * (p + hw))

    def make_precond(g_w):
        if precond_kind == "sherman":
            return sherman_inv
        if precond_kind == "filter":
            return lambda r: plan.pipeline(r, "mul", g_w)
        return lambda r: r

    # -- normal-equation loops (image-space rhs) ---------------------------
    def cg_loop(rhs, d2, srow, g_w, tol):
        ref = _bnorm(rhs)
        safe = _safe(ref)
        precond = make_precond(g_w)
        hist = _history(maxiter, ref)
        best = hist[0].clone()
        x = xb = torch.zeros_like(rhs)
        r = rhs
        pdir = z = precond(r)
        rz = _bdot(r, z)
        conv = ref <= 0
        stall = torch.zeros_like(conv)
        k = 0
        while _running(k, maxiter, conv | stall):
            q = normal(pdir, d2, srow)
            pq = _bdot(pdir, q)
            # frozen batch elements take alpha = beta = 0 rather than 0/0
            ok = ~(conv | stall) & (pq > 0)
            alpha = torch.where(ok, rz / torch.where(pq == 0, 1, pq), 0)
            x = x + _bx(alpha) * pdir
            r = r - _bx(alpha) * q
            z = precond(r)
            rz_new = _bdot(r, z)
            beta = torch.where(ok & (rz > 0),
                               rz_new / torch.where(rz == 0, 1, rz), 0)
            pdir = torch.where(_bx(ok), z + _bx(beta) * pdir, pdir)
            rz = rz_new
            rn = _bnorm(r) / safe
            improved = ok & (rn < best)
            xb = torch.where(_bx(improved), x, xb)
            best = torch.where(improved, rn, best)
            conv = conv | (ok & (rn <= tol))
            stall = stall | (~conv & ((pq <= 0) | (rn > 100 * best)))
            hist[k + 1] = rn
            k += 1
        ITERATIONS["cg"] += k
        return xb, hist, k, conv.all()

    def landweber_loop(rhs, d2, srow, tol, tau):
        ref = _bnorm(rhs)
        safe = _safe(ref)
        if tau is None:
            # the exact bound ||M||^2 <= max(d^2) (P + HW)
            tau = 1.0 / (d2.max().clamp_min(1e-30) * (p + hw))
        hist = _history(maxiter, ref)
        x = torch.zeros_like(rhs)
        conv = ref <= 0
        k = 0
        while _running(k, maxiter, conv):
            r = rhs - normal(x, d2, srow)
            x = x + torch.where(_bx(conv), 0, tau * r)
            rn = _bnorm(r) / safe
            conv = conv | (rn <= tol)
            hist[k + 1] = rn
            k += 1
        ITERATIONS["landweber"] += k
        return x, hist, k, conv.all()

    # -- LSQR: Golub-Kahan bidiagonalization on M = D A itself -------------
    def lsqr_loop(bw, d, tol):
        def m_apply(v):
            return d * plan.forward(v)

        def mt_apply(u):
            return atd(d * u)

        beta = _bnorm(bw)
        u = torch.where(_bx(beta > 0), bw / _bx(_safe(beta)), 0)
        v0 = mt_apply(u)
        alpha = _bnorm(v0)
        v = torch.where(_bx(alpha > 0), v0 / _bx(_safe(alpha)), 0)
        ref = alpha * beta            # == ||M^T b_w|| by construction
        safe = _safe(ref)
        hist = _history(maxiter, ref)
        x = torch.zeros_like(v)
        w_dir, phibar, rhobar = v, beta, alpha
        conv = ref <= 0
        k = 0
        while _running(k, maxiter, conv):
            un = m_apply(v) - _bx(alpha) * u
            beta = _bnorm(un)
            u = torch.where(_bx(beta > 0), un / _bx(_safe(beta)), 0)
            vn = mt_apply(u) - _bx(beta) * v
            alpha = _bnorm(vn)
            v = torch.where(_bx(alpha > 0), vn / _bx(_safe(alpha)), 0)
            rho = torch.sqrt(rhobar * rhobar + beta * beta)
            rho_s = _safe(rho)
            c = rhobar / rho_s
            s = beta / rho_s
            theta = s * alpha
            rhobar = -c * alpha
            phi = c * phibar
            phibar = s * phibar
            gain = torch.where(conv, 0, phi / rho_s)
            x = x + _bx(gain) * w_dir
            w_dir = torch.where(_bx(conv), w_dir,
                                v - _bx(theta / rho_s) * w_dir)
            # Paige-Saunders estimate ||M^T r_k|| = phibar_k alpha_k |c_k|
            rn = phibar * alpha * c.abs() / safe
            conv = conv | (rn <= tol)
            hist[k + 1] = rn
            k += 1
        ITERATIONS["lsqr"] += k
        return x, hist, k, conv.all()

    # -- assembled method bodies -------------------------------------------
    def d2_parts(d):
        d2 = d * d
        return d2, d2[..., 0, :w]

    def result(x, hist, k, conv):
        return SolveResult(x, hist, torch.full((), k, dtype=torch.int32,
                                               device=x.device), conv)

    if method == "sherman":
        def run(b, d, g_w, tol, tau):
            rhs = atd(b)
            x = sherman_inv(rhs)
            # closed-form normal residual: A^T A x = P x + total(x) 1
            gx = p * x + x.sum((-2, -1), keepdim=True)
            rel = _bnorm(rhs - gx) / _safe(_bnorm(rhs))
            hist = torch.stack([torch.ones_like(rel), rel])
            return SolveResult(x, hist, torch.zeros((), dtype=torch.int32,
                                                    device=x.device),
                               torch.ones((), dtype=torch.bool,
                                          device=x.device))

        def image_of(v, d, g_w, tol, tau):
            return sherman_inv(atd(v))

        def transpose(ct, d, g_w, tol, tau):
            # L = C A^T with C = (A^T A)^{-1} symmetric => L^T = A C
            return plan.forward(sherman_inv(ct))
    else:
        def normal_solve(rhs, d, g_w, tol, tau):
            d2, srow = d2_parts(d)
            if method == "landweber":
                return landweber_loop(rhs, d2, srow, tol, tau)
            return cg_loop(rhs, d2, srow, g_w, tol)

        def run(b, d, g_w, tol, tau):
            if method == "lsqr":
                return result(*lsqr_loop(d * b, d, tol))
            d2, _srow = d2_parts(d)
            return result(*normal_solve(atd(d2 * b), d, g_w, tol, tau))

        def image_of(v, d, g_w, tol, tau):
            # the converged linear map b -> G^+ A^T D^2 b on a tangent
            # sinogram (LSQR's tangent routes through the same normal-
            # equation solve: the fixed points agree)
            d2, _srow = d2_parts(d)
            return normal_solve(atd(d2 * v), d, g_w, tol, tau)[0]

        def transpose(ct, d, g_w, tol, tau):
            # L^T = D^2 A G^+ (G symmetric): solve with ct as the rhs,
            # then push forward through the masked operator
            d2, _srow = d2_parts(d)
            return d2 * plan.forward(normal_solve(ct, d, g_w, tol, tau)[0])

    def forward(b, d, g_w, tol, tau):
        return tuple(run(b, d, g_w, tol, tau))

    def setup_context(ctx, inputs, output):
        _b, d, g_w, tol, tau = inputs
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(d, g_w)
        ctx.save_for_forward(d, g_w)
        ctx.knobs = (tol, tau)

    @once_differentiable
    def backward(ctx, ct, *_frozen):
        d, g_w = ctx.saved_tensors
        return (transpose(ct.contiguous(), d, g_w, *ctx.knobs),
                None, None, None, None)

    def jvp(ctx, tb, *_frozen):
        d, g_w = ctx.saved_tensors
        return image_of(tb, d, g_w, *ctx.knobs), None, None, None

    return type(f"Solve{method.title()}Fn", (torch.autograd.Function,), {
        "__doc__": f"The {method} solve of one plan: linear in the "
                   f"sinogram; backward applies its transpose, jvp the "
                   f"map itself.",
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(backward),
        "jvp": staticmethod(jvp),
    })


def _solver(plan, method: str, maxiter: int, precond_kind: str):
    return plan_applier(
        plan, f"solve:{method}",
        lambda: _build_solver(plan, method, maxiter, precond_kind),
        variant=(int(maxiter), precond_kind))


# ---------------------------------------------------------------------------
# the public entry point
# ---------------------------------------------------------------------------
def _resolve_precond(precond, fdtype, device):
    """``(kind, weights)``: filter weights move to ``device``, as a
    :class:`ProjectionFilter` moves them to its input's."""
    if precond is None:
        return "none", None
    if isinstance(precond, str):
        if precond != "sherman":
            raise ValueError(
                f"unknown precond {precond!r}: 'sherman', a "
                f"ProjectionFilter, or a (…, P+1, P) weight array")
        return "sherman", None
    if isinstance(precond, ProjectionFilter):
        precond = precond.weights
    g_w = torch.as_tensor(precond).to(device=device, dtype=fdtype)
    if g_w.ndim < 2 or g_w.shape[-2] != g_w.shape[-1] + 1:
        raise ValueError(f"precond weights must be (…, P+1, P), got "
                         f"{tuple(g_w.shape)}")
    return "filter", g_w.contiguous()


def solve(op, sinogram, method: str = "auto", *, mask=None, weight=None,
          precond=None, tol: float = 1e-6, maxiter: int = 100,
          tau: Optional[float] = None) -> SolveResult:
    """Reconstruct an image (stack) from (masked/weighted) projections.

    ``op`` is a forward :class:`~repro_torch.radon.RadonOperator`
    (``mask`` / ``weight`` build the :class:`MaskedDPRT` here, on the
    sinogram's device) or an already-built ``MaskedDPRT``, whose
    diagonal must live on the sinogram's device.  ``method``: ``"auto"``
    picks the Sherman-Morrison closed form when nothing is masked and CG
    on the normal equations otherwise; ``"cg"`` accepts ``precond``
    (``"sherman"`` or a ``ProjectionFilter`` / weight array).  ``tau``
    is the Landweber step (default: the exact spectral bound).

    Returns a :class:`SolveResult`; see the module docstring for the
    convergence, batching and differentiation contracts.
    """
    b = torch.as_tensor(sinogram)
    if isinstance(op, MaskedDPRT):
        if mask is not None or weight is not None:
            raise ValueError(
                "pass mask/weight either to MaskedDPRT or to solve(), "
                "not both")
        if op._adjoint:
            raise ValueError("solve() expects the forward measurement "
                             "operator, got its adjoint")
        m = op
    else:
        m = MaskedDPRT(op, mask=mask, weight=weight, device=b.device)
    plan = m.plan
    if tuple(b.shape) != plan.geometry.transform_shape:
        raise ValueError(
            f"sinogram shape {tuple(b.shape)} != operator projections "
            f"{plan.geometry.transform_shape}")
    m._check_device(b)
    b = b.to(m.fdtype)

    unmasked = m.is_identity_diagonal
    if method == "auto":
        method = "sherman" if unmasked else "cg"
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    if method == "sherman" and not unmasked:
        raise ValueError(
            "the Sherman-Morrison fast path is exact only for the "
            "unmasked, unweighted operator; use cg/lsqr/landweber")
    precond_kind, g_w = _resolve_precond(precond, m.fdtype, b.device)
    if precond_kind != "none" and method != "cg":
        raise ValueError(
            f"precond applies to method='cg' only (sherman is direct, "
            f"lsqr/landweber run unpreconditioned); got method={method!r}")
    if int(maxiter) < 1 and method != "sherman":
        raise ValueError(f"maxiter must be >= 1, got {maxiter}")
    if torch.is_grad_enabled():
        for name, t in (("mask/weight diagonal", m.d),
                        ("preconditioner", g_w)):
            if t is not None and t.requires_grad:
                raise ValueError(
                    f"radon.solve is linear in the sinogram only; the "
                    f"{name} is not a differentiable input")

    fn = _solver(plan, method, 0 if method == "sherman" else int(maxiter),
                 precond_kind)
    return SolveResult(*fn.apply(
        b, m.d, g_w, float(tol), None if tau is None else float(tau)))


# ---------------------------------------------------------------------------
# the servable operator surface
# ---------------------------------------------------------------------------
class ReconstructionOperator(_AOTSurface):
    """``sinogram -> reconstructed image`` as an operator.

    Wraps one :class:`~repro_torch.radon.MaskedDPRT` + solver
    configuration with the operator contract (``shape_in`` /
    ``dtype_in``, ``@``) and the AOT surface (``compile(device)`` builds
    the kernels and the solver body with one warm solve of an all-ones
    sinogram; ``device`` must be the diagonal's).  ``__call__`` returns
    the image only -- diagnostics stay on :func:`solve` -- so it chains
    like any other stage.
    """

    __slots__ = ("masked", "solver", "tol", "maxiter", "tau",
                 "precond_kind", "precond_w")

    def __init__(self, masked: MaskedDPRT, solver: str = "auto", *,
                 tol: float = 1e-6, maxiter: int = 50,
                 tau: Optional[float] = None, precond=None):
        if not isinstance(masked, MaskedDPRT) or masked._adjoint:
            raise ValueError(
                f"ReconstructionOperator wraps a forward MaskedDPRT, "
                f"got {masked!r}")
        if solver == "auto":
            solver = "sherman" if masked.is_identity_diagonal else "cg"
        if solver not in METHODS:
            raise ValueError(f"unknown solver {solver!r}; one of {METHODS}")
        kind, g_w = _resolve_precond(precond, masked.fdtype, masked.d.device)
        object.__setattr__(self, "masked", masked)
        object.__setattr__(self, "solver", solver)
        object.__setattr__(self, "tol", float(tol))
        object.__setattr__(self, "maxiter", int(maxiter))
        object.__setattr__(self, "tau",
                           None if tau is None else float(tau))
        object.__setattr__(self, "precond_kind", kind)
        object.__setattr__(self, "precond_w", g_w)

    def __setattr__(self, name, value):
        raise AttributeError("ReconstructionOperator is immutable")

    @property
    def plan(self):
        return self.masked.plan

    @property
    def shape_in(self):
        return self.plan.geometry.transform_shape

    @property
    def shape_out(self):
        return self.plan.geometry.image_shape

    @property
    def dtype_in(self) -> torch.dtype:
        return self.masked.fdtype

    dtype_out = dtype_in

    def __call__(self, sinogram: torch.Tensor) -> torch.Tensor:
        precond = {"filter": self.precond_w, "sherman": "sherman"}.get(
            self.precond_kind)
        return solve(self.masked, sinogram, self.solver, precond=precond,
                     tol=self.tol, maxiter=self.maxiter,
                     tau=self.tau).image

    def __matmul__(self, other):
        from .operators import _compose
        return _compose(self, other)

    # -- AOT ---------------------------------------------------------------
    def _aot_key(self, device):
        return ("recon", self.plan, self.solver, self.maxiter, self.tol,
                self.tau, self.precond_kind, id(self.masked.d), str(device))

    def _aot_pins(self) -> tuple:
        return tuple(t for t in (self.masked.d, self.precond_w)
                     if t is not None)

    def _aot_plan(self) -> dict:
        return _plan_record(self.plan)

    def _aot_prepare(self, device):
        return self

    def cache_token(self, device="cuda") -> str:
        """Like the transform operators' token, plus the solver knobs and
        a digest of the diagonal (and preconditioner)."""
        pl = self.plan
        shape = "x".join(str(s) for s in self.shape_in)
        return (f"recon_{shape}_{dtype_name(self.dtype_in)}_{pl.method}_"
                f"{self.solver}_t{self.tol:g}_i{self.maxiter}_"
                f"p{self.precond_kind}_"
                f"d{_digest(self.masked.d, self.precond_w)}_"
                f"{_knob_token(pl)}_"
                f"{_topology_token(torch.device(device), pl.mesh)}")

    def describe(self) -> dict:
        d = dict(self.plan.describe())
        d.update(kind="recon", solver=self.solver, tol=self.tol,
                 maxiter=self.maxiter, precond=self.precond_kind,
                 shape_in=self.shape_in, shape_out=self.shape_out)
        return d

    def __repr__(self) -> str:
        return (f"ReconstructionOperator({self.shape_in}->"
                f"{self.shape_out}, solver={self.solver!r}, "
                f"tol={self.tol:g}, maxiter={self.maxiter}, "
                f"method={self.plan.method!r})")


def solve_operator(shape, dtype=torch.float32, *, mask=None, weight=None,
                   solver: str = "auto", tol: float = 1e-6,
                   maxiter: int = 50, tau: Optional[float] = None,
                   precond=None, method: Optional[str] = None,
                   device="cuda", **knobs) -> ReconstructionOperator:
    """Build a reconstruction operator for one image geometry.

    ``shape`` is ``(H, W)`` or ``(B, H, W)``; ``method`` / ``**knobs``
    are the transform-plan knobs (backend, blocking, mesh),
    ``solver`` / ``tol`` / ``maxiter`` / ``tau`` / ``precond`` the
    solver configuration, ``mask`` / ``weight`` the projection-domain
    diagonal, and ``device`` places an all-ones diagonal when neither is
    given (a port keyword: the reference's arrays have no device).  The
    sinogram contract is ``(…, P+1, P)`` in
    :func:`repro_torch.core.dprt.float_dtype_for` of ``dtype``.
    """
    fwd = DPRT(shape, dtype, method, **knobs)
    masked = MaskedDPRT(fwd, mask=mask, weight=weight, device=device)
    return ReconstructionOperator(masked, solver, tol=tol,
                                  maxiter=maxiter, tau=tau,
                                  precond=precond)
