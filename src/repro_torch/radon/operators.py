"""First-class linear-operator objects over cached transform plans.

The port of :mod:`repro.radon.operators` (without the AOT methods
``lower`` / ``cache_token`` / ``export_executable``: ROADMAP Queue 1
item 4b).  ``op = radon.DPRT(shape, dtype)`` builds (or fetches: plans
are cached) the forward DPRT operator for one input geometry:

    op(f)            # apply: (…, H, W) -> (…, P+1, P), differentiable
    op.inverse       # the exact inverse transform (crops the embedding)
    op.T             # the exact adjoint -- A^T, NOT the inverse
    op.inverse.T     # adjoint of the inverse == (A^T)^-1
    op2 @ op1        # composition (applied right-to-left)
    op.compile(dev)  # build the kernels and make one warm call
    op.as_matrix()   # dense (out_size, in_size) matrix (small N; tests)

The projection-domain fusion surface: :class:`Conv2D` (exact circular
convolution by a fixed kernel) and ``op.inverse @ ProjectionFilter(w)
@ op``, which :class:`CompositeOperator` rewrites into one
:class:`FusedProjectionPipeline` -- each one K2 call on the ``cuda``
backend, the staged fallback elsewhere.

Operators are device-agnostic: they run on the device of the tensor
they are given.  Every application routes through
:mod:`repro_torch.radon.autodiff` or :mod:`repro_torch.radon.fusion`,
so gradients are exact for every backend.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dprt import accum_dtype_for, as_dtype, dtype_name
from ..core.plan import (RadonPlan, _canonical_method,
                         _mesh_for_description, get_plan)
from . import ambient
from .autodiff import INVERSE_OF, TRANSPOSE_OF, apply_plan, trace_count
from .fusion import flip_image, pipeline_apply

__all__ = ["DPRT", "Conv2D", "ProjectionFilter", "FusedProjectionPipeline",
           "RadonOperator", "CompositeOperator", "operator_for",
           "conv2d_from_description", "projection_filter_from_numpy"]


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
        """Builds of this operator's plan so far (1 once it exists);
        pipeline appliers built on the same plan are counted under their
        own kind, not here."""
        return trace_count(self.plan, kind="plan")

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
    """``left @ right``: flatten into one CompositeOperator (which then
    recognizes fusible patterns)."""
    if not (_is_operator_like(left) and _is_operator_like(right)):
        return NotImplemented
    lops = left.ops if isinstance(left, CompositeOperator) else (left,)
    rops = right.ops if isinstance(right, CompositeOperator) else (right,)
    return CompositeOperator(lops + rops)


def _is_operator_like(x) -> bool:
    return callable(x) and hasattr(x, "shape_in") and hasattr(x, "shape_out")


def _fuse_ops(ops: Tuple) -> Tuple:
    """Recognize ``inv @ pointwise @ fwd`` triples over one plan and
    replace them with the fused projection pipeline (one K2 call on
    capable backends; staged fallback otherwise)."""
    fused, i = [], 0
    while i < len(ops):
        a = ops[i]
        if (i + 2 < len(ops)
                and isinstance(a, RadonOperator) and a.kind == "inverse"
                and isinstance(ops[i + 1], ProjectionFilter)
                and isinstance(ops[i + 2], RadonOperator)
                and ops[i + 2].kind == "forward"
                and a.plan == ops[i + 2].plan
                and tuple(ops[i + 1].weights.shape[-2:])
                == tuple(a.plan.geometry.transform_shape[-2:])):
            fused.append(FusedProjectionPipeline(
                a.plan, ops[i + 1].weights, ops[i + 2].dtype))
            i += 3
        else:
            fused.append(a)
            i += 1
    return tuple(fused)


class CompositeOperator:
    """Right-to-left composition of operators: ``(g @ f)(x) == g(f(x))``.

    Supports the same algebra (``.T`` reverses and transposes,
    ``.inverse`` reverses and inverts); shape chaining is validated at
    construction, and ``inverse @ ProjectionFilter @ forward`` triples
    over one plan are rewritten into the fused projection pipeline.
    """

    __slots__ = ("ops",)

    def __init__(self, ops: Tuple):
        if not ops:
            raise ValueError("CompositeOperator needs at least one operator")
        ops = _fuse_ops(tuple(ops))
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


class ProjectionFilter:
    """Pointwise projection-domain filter: ``r -> weights * r``.

    A diagonal (self-adjoint) linear operator on ``(…, P+1, P)``
    projections.  Its value is in composition:
    ``op.inverse @ ProjectionFilter(w) @ op`` is rewritten by
    :class:`CompositeOperator` into one fused pipeline call.
    Shape-polymorphic over leading batch dims (``shape_in`` /
    ``shape_out`` are ``None`` wildcards for chaining).
    """

    __slots__ = ("weights",)

    def __init__(self, weights):
        weights = torch.as_tensor(weights)
        if weights.ndim not in (2, 3) or \
                weights.shape[-2] != weights.shape[-1] + 1:
            raise ValueError(f"projection weights must be (…, P+1, P), "
                             f"got {tuple(weights.shape)}")
        object.__setattr__(self, "weights", weights)

    def __setattr__(self, name, value):
        raise AttributeError("ProjectionFilter is immutable")

    shape_in = None   # polymorphic: any (…, P+1, P) matching the weights
    shape_out = None

    @property
    def dtype_in(self) -> torch.dtype:
        return self.weights.dtype

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return r * self.weights.to(r.dtype).to(r.device)

    @property
    def T(self) -> "ProjectionFilter":
        return self    # diagonal and real: self-adjoint

    @property
    def inverse(self):
        raise TypeError(
            "ProjectionFilter has no exact inverse (1/weights is not an "
            "integer-exact operation); build the reciprocal filter "
            "explicitly if that is what you mean")

    def __matmul__(self, other):
        return _compose(self, other)

    def __repr__(self) -> str:
        return f"ProjectionFilter({tuple(self.weights.shape)})"


class FusedProjectionPipeline:
    """``inverse @ ProjectionFilter @ forward`` collapsed onto one plan:
    the fused ``mul`` pipeline (one K2 call on capable backends; staged
    fallback otherwise), exactly differentiable through
    :mod:`repro_torch.radon.fusion`."""

    __slots__ = ("plan", "weights", "dtype")

    def __init__(self, plan: RadonPlan, weights, dtype):
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "weights", torch.as_tensor(weights))
        object.__setattr__(self, "dtype", as_dtype(dtype))

    def __setattr__(self, name, value):
        raise AttributeError("FusedProjectionPipeline is immutable")

    @property
    def shape_in(self):
        return self.plan.geometry.image_shape

    shape_out = property(lambda self: self.plan.geometry.image_shape)

    @property
    def dtype_in(self) -> torch.dtype:
        # the forward operator it swallowed consumed raw images of the
        # declared dtype: fusion does not change the input signature
        return self.dtype

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        return pipeline_apply(self.plan, f, "mul", self.weights.to(f.device))

    @property
    def T(self) -> CompositeOperator:
        """(B W A)^T = A^T W B^T: the exact-adjoint datapaths around the
        self-adjoint filter (not itself a fusible pattern)."""
        return CompositeOperator((
            RadonOperator(self.plan, "adjoint", self.dtype),
            ProjectionFilter(self.weights),
            RadonOperator(self.plan, "inverse_adjoint", self.dtype)))

    @property
    def inverse(self):
        raise TypeError(
            "FusedProjectionPipeline (inverse @ filter @ forward) has no "
            "exact inverse: the pointwise filter is not invertible in "
            "exact arithmetic")

    def __matmul__(self, other):
        return _compose(self, other)

    def __repr__(self) -> str:
        return (f"FusedProjectionPipeline({self.shape_in}, "
                f"method={self.plan.method!r})")


class Conv2D:
    """Exact circular 2-D convolution by a fixed kernel, as an operator.

    ``Conv2D(shape, kernel)`` convolves ``(H, W)`` images (or
    ``(B, H, W)`` stacks) with ``kernel`` on the ``(H, W)`` torus.  On
    square prime geometries the application is the fused projection
    pipeline: one K2 call on the ``cuda`` backend, against the kernel
    image (single images) or, for a stack, against the kernel's
    projections from one forward of the kernel alone.  Other geometries
    fold the exact prime-embedded linear convolution onto the torus.
    Autograd is exact in the image and in the kernel (a ``kernel`` that
    requires grad).

    ``op.T`` is the exact adjoint -- circular *correlation*, i.e.
    convolution by the torus-flipped kernel.  ``as_matrix()`` builds the
    dense circulant for small-N tests.
    """

    __slots__ = ("plan", "kernel", "dtype")

    def __init__(self, shape, kernel, dtype=None, method: Optional[str] = None,
                 *, strip_rows: Optional[int] = None,
                 m_block: Optional[int] = None,
                 batch_impl: Optional[str] = None,
                 block_rows: Optional[int] = None,
                 stream_rows: Optional[int] = None,
                 block_batch: Optional[int] = None,
                 mesh=None):
        kernel = torch.as_tensor(kernel)
        shape = tuple(int(s) for s in shape)
        h, w = shape[-2:]
        if kernel.ndim != 2 or kernel.shape[0] > h or kernel.shape[1] > w:
            raise ValueError(
                f"kernel must be 2-D and fit the {shape[-2:]} torus, "
                f"got {tuple(kernel.shape)}")
        dtype = kernel.dtype if dtype is None else as_dtype(dtype)
        # the kernel lives zero-padded on the full (H, W) torus
        kernel = F.pad(kernel.to(dtype),
                       (0, w - kernel.shape[1], 0, h - kernel.shape[0]))
        plan = DPRT(shape, dtype, method, strip_rows=strip_rows,
                    m_block=m_block, batch_impl=batch_impl,
                    block_rows=block_rows, stream_rows=stream_rows,
                    block_batch=block_batch, mesh=mesh).plan
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "kernel", kernel)
        object.__setattr__(self, "dtype", dtype)

    def __setattr__(self, name, value):
        raise AttributeError("Conv2D is immutable")

    @property
    def shape_in(self):
        return self.plan.geometry.image_shape

    shape_out = property(lambda self: self.plan.geometry.image_shape)

    @property
    def dtype_in(self) -> torch.dtype:
        return self.dtype

    @property
    def dtype_out(self) -> torch.dtype:
        return accum_dtype_for(self.dtype, self.plan.geometry.prime)

    def _knob_kwargs(self) -> dict:
        p = self.plan
        return dict(strip_rows=p.strip_rows, m_block=p.m_block,
                    batch_impl=p.batch_impl, block_rows=p.block_rows,
                    stream_rows=p.stream_rows, block_batch=p.block_batch,
                    mesh=p.mesh)

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        g = self.plan.geometry
        kernel = self.kernel.to(f.device)
        if g.native:
            if g.batched:   # one forward of the kernel serves the stack
                p = g.prime
                kernel = DPRT((p, p), self.dtype, self.plan.method,
                              **self._knob_kwargs())(kernel)
            return pipeline_apply(self.plan, f, "conv", kernel)
        # non-native: the true (H, W)-torus convolution = fold of the
        # exact linear convolution; the plan's knobs travel via an
        # ambient scope, which conv resolves per call
        from ..core.conv import circ_conv2d_dprt  # lazy: conv -> radon
        p = self.plan
        with ambient.config(mesh=p.mesh, batch_impl=p.batch_impl,
                            block_rows=p.block_rows,
                            stream_rows=p.stream_rows,
                            block_batch=p.block_batch):
            return circ_conv2d_dprt(f, kernel, method=p.method,
                                    strip_rows=p.strip_rows,
                                    m_block=p.m_block)

    @property
    def T(self) -> "Conv2D":
        """Circular correlation: convolution by the torus-flipped kernel
        (same plan knobs, blocking and batching included)."""
        return Conv2D(self.shape_in, flip_image(self.kernel), self.dtype,
                      self.plan.method, **self._knob_kwargs())

    def __matmul__(self, other):
        return _compose(self, other)

    @property
    def inverse(self):
        raise TypeError(
            "Conv2D has no exact inverse (deconvolution is not an "
            "integer-exact operation)")

    def as_matrix(self, device="cuda") -> torch.Tensor:
        """Dense (H*W, H*W) circulant of this convolution (small N)."""
        size = 1
        for s in self.shape_in:
            size *= s
        basis = torch.eye(size, dtype=self.dtype, device=device)
        cols = [self(e.reshape(self.shape_in)).reshape(-1) for e in basis]
        return torch.stack(cols, dim=1)

    def describe(self) -> dict:
        d = dict(self.plan.describe())
        d.update(kind="conv2d", kernel_shape=tuple(self.kernel.shape),
                 pipeline=self.plan.backend.pipeline is not None)
        return d

    def __repr__(self) -> str:
        return (f"Conv2D({self.shape_in}, kernel="
                f"{tuple(self.kernel.shape)}, {dtype_name(self.dtype)}, "
                f"method={self.plan.method!r})")


def conv2d_from_description(desc: dict, kernel, mesh=None) -> Conv2D:
    """The port's :class:`Conv2D` for a reference ``Conv2D.describe()``
    dict and the reference operator's ``kernel`` as a numpy array: same
    geometry, dtype, method (``pallas`` -> ``cuda``, ``sharded_pallas``
    -> ``sharded_cuda``) and knobs, so both packages compute the same
    convolution.  A description on a mesh needs ``mesh=``, a DeviceMesh
    with its dim names and sizes."""
    if desc.get("kind") != "conv2d":
        raise ValueError(f"not a Conv2D description: kind="
                         f"{desc.get('kind')!r}")
    mesh = _mesh_for_description(desc, mesh)
    op = Conv2D(desc["image_shape"], torch.from_numpy(np.array(kernel)),
                desc["dtype"], desc["requested_method"],
                strip_rows=desc.get("strip_rows"),
                m_block=desc.get("m_block"),
                block_rows=desc.get("block_rows"),
                stream_rows=desc.get("stream_rows"),
                block_batch=desc.get("block_batch"),
                mesh=mesh)
    if op.plan.method != _canonical_method(desc["method"]):
        raise ValueError(f"description resolved to {desc['method']!r}, the "
                         f"port resolves {desc['requested_method']!r} to "
                         f"{op.plan.method!r}")
    if tuple(op.kernel.shape) != tuple(desc["kernel_shape"]):
        raise ValueError(f"kernel {tuple(op.kernel.shape)} does not match "
                         f"the description's {desc['kernel_shape']}")
    return op


def projection_filter_from_numpy(weights) -> ProjectionFilter:
    """The port's :class:`ProjectionFilter` for a reference filter's
    ``weights`` as a numpy array."""
    return ProjectionFilter(torch.from_numpy(np.array(weights)))


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
    ``cuda`` kernel backend for int/float images).  ``stream_rows=H``
    streams giant images through ONE launch of the streamed kernel (K5)
    each way, in strips of at most H rows.  ``mesh`` (a
    ``torch.distributed`` DeviceMesh with dims ``("data", "model")`` or
    ``("model",)``; call on every rank) resolves ``method="auto"`` to
    the ``sharded_cuda`` backend: image rows shard over ``"model"``, a
    batch over ``"data"``, each rank runs K1 on its block, and every
    rank gets the whole result.
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
