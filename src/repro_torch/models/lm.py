"""Model assembly: embeddings + (prefix | stacked body | tail) layers.

The port of :mod:`repro.models.lm`.  Layers whose kinds repeat
periodically are stacked along a leading axis, as in the reference; the
reference runs them under ``lax.scan``, the port by a Python loop over
that axis.  Irregular layers (e.g. DeepSeek-V2's first dense layer,
pattern remainders) run one by one.

:class:`Model` is an ``nn.Module`` whose parameters sit under the
reference's tree paths (``embed.embedding``, ``body.0.attn.wq``, ...).
It is built from its configuration alone; :meth:`Model.load_params`
installs a parameter tree (from :func:`~repro_torch.parallel.sharding.
init_params`, or the reference's through
:func:`~repro_torch.models.convert.params_from_reference`), as
parameters that do not require grad.

Three entry points:
  * ``forward``     -- teacher-forced logits over a full batch,
  * ``prefill``     -- forward + KV/state cache construction,
  * ``decode_step`` -- one-token step against the cache, which it
    updates in place.

Each takes ``params=``, a parameter tree to run on in place of the
installed one.  Training uses it: ``loss(batch, params=tree)`` is a
function of the tree, as the reference's ``loss(params, batch)``, and
the trainer differentiates it with respect to leaves that require grad
(:func:`repro_torch.optim.value_and_grad`) -- the port turns on
``requires_grad`` for the trainer's own parameters rather than going
through ``torch.func.functional_call``, and the installed parameters
stay frozen for serving.  ``prefill`` and ``decode_step`` run under
``torch.inference_mode()``; ``forward`` and ``loss`` carry autograd.

``cfg.remat`` is the reference's rematerialisation of each stacked
group and encoder layer when gradients are taken
(``torch.utils.checkpoint``, non-reentrant): ``"full"`` saves nothing
and recomputes the group in the backward pass, ``"dots"`` saves the
outputs of the unbatched matrix products (``aten.mm``, the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, and
``"none"`` keeps every activation.  The values do not depend on it;
only the memory does.

**Tensor parallelism.**  Every entry point takes ``tp``, this rank's
place on the mesh's ``model`` axis (a :class:`~repro_torch.parallel.
tensor.AxisGroup`; ``None``: the whole model), and then ``params=`` is
this rank's shards (:func:`~repro_torch.parallel.sharding.shard_params`)
and a cache this rank's (:meth:`Model.init_cache` with the same
``tp``).  The layers split their work over the axis themselves; the
embedding, the logits and the loss are split over the vocabulary.
``forward``, ``prefill`` and ``decode_step`` return the whole logits on
every rank; ``loss`` is the same value on every rank.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..parallel import tensor as T
from ..parallel.sharding import ParamSpec, shard_act, stack_specs
from ..tree import tree_map
from .blocks import (CACHE_MODEL_DIMS, apply_block, block_cache_shapes,
                     block_specs)
from .config import ModelConfig
from .layers import (cross_entropy_loss, embed_specs, embed_tokens, rmsnorm,
                     rmsnorm_spec, unembed)

__all__ = ["Model", "check_tree"]


def _save_mm(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep unbatched matrix products' outputs."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` rematerialised in the backward pass by ``mode`` (the
    reference's ``_remat``: any mode but none and dots is full); the
    plain call where no gradient is taken."""
    if mode == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if mode == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts,
                                  _save_mm))
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def _is_shape(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(t, int) for t in v)


def _map_shapes(fn, tree, name: str = ""):
    """``fn(leaf_name, shape)`` over a tree of shape tuples."""
    if _is_shape(tree):
        return fn(name, tree)
    return {k: _map_shapes(fn, v, k) for k, v in tree.items()}


def _unstack(tree, n: int):
    """A tree of stacked leaves -> ``n`` trees of views of its layers."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return tree.unbind(0)


def _write_back(cache, new):
    """Copy a decode step's new state leaves (recurrent and conv states
    are new tensors; K/V caches were written in place) into ``cache``."""
    def put(c, n):
        if n is not c:
            c.copy_(n)
        return c

    return tree_map(put, cache, new)


def check_tree(tree, specs, path: str = "") -> None:
    """Raise unless ``tree`` has exactly the leaves of ``specs``, each of
    its spec's shape."""
    if isinstance(specs, ParamSpec):
        if isinstance(tree, dict):
            raise ValueError(f"{path}: a subtree where a parameter belongs")
        if tuple(tree.shape) != tuple(specs.shape):
            raise ValueError(f"{path}: shape {tuple(tree.shape)}, the "
                             f"model needs {specs.shape}")
        return
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: a leaf where a subtree belongs")
    missing = sorted(set(specs) - set(tree))
    extra = sorted(set(tree) - set(specs))
    if missing or extra:
        raise ValueError(f"{path or '<root>'}: missing {missing}, "
                         f"extra {extra}")
    for k in specs:
        check_tree(tree[k], specs[k], f"{path}.{k}" if path else k)


class _Node(nn.Module):
    """One subtree of parameters: leaves as parameters, subtrees as
    children, both under the tree's keys."""

    def __init__(self, tree):
        super().__init__()
        _install(self, tree)


def _install(module: nn.Module, tree) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            module.add_module(k, _Node(v))
        else:
            module.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _as_tree(module: nn.Module):
    out = dict(module._parameters)
    for k, m in module._modules.items():
        out[k] = _as_tree(m)
    return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.kinds = cfg.layer_kinds()
        pl = len(cfg.block_pattern)
        start = cfg.first_dense_layers
        if cfg.scan_layers and cfg.num_layers - start >= pl:
            self.n_groups = (cfg.num_layers - start) // pl
        else:
            self.n_groups = 0
        self.body_start = start
        self.tail_start = start + self.n_groups * pl
        self.pattern_kinds = [
            self.kinds[start + p] for p in range(pl)] if self.n_groups else []
        self.prefix_ids = list(range(0, self.body_start))
        self.tail_ids = list(range(self.tail_start, cfg.num_layers))
        self.use_rope = cfg.learned_pos == 0
        self.cross = cfg.cross_attention

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        s: Dict[str, Any] = {
            "embed": embed_specs(cfg.padded_vocab, cfg.d_model,
                                 cfg.tie_embeddings, max_pos=cfg.learned_pos),
            "final_norm": rmsnorm_spec(cfg.d_model),
        }
        if self.prefix_ids:
            s["prefix"] = {str(i): block_specs(cfg, *self.kinds[i],
                                               cross=self.cross)
                           for i in self.prefix_ids}
        if self.n_groups:
            s["body"] = {str(p): stack_specs(
                block_specs(cfg, *self.pattern_kinds[p], cross=self.cross),
                self.n_groups) for p in range(len(self.pattern_kinds))}
        if self.tail_ids:
            s["tail"] = {str(i): block_specs(cfg, *self.kinds[i],
                                             cross=self.cross)
                         for i in self.tail_ids}
        if cfg.encoder_layers:
            s["encoder"] = {
                "body": stack_specs(block_specs(cfg, "attn", "dense"),
                                    cfg.encoder_layers),
                "final_norm": rmsnorm_spec(cfg.d_model),
            }
        return s

    def load_params(self, tree) -> "Model":
        """Install a parameter tree (tensors under the reference's keys);
        raises on a missing or extra leaf or a wrong shape."""
        check_tree(tree, self.specs())
        self._modules.clear()
        self._parameters.clear()
        _install(self, tree)
        return self

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as a tree of tensors under the reference's keys."""
        if not self._parameters:
            raise RuntimeError("no parameters: call load_params first")
        return _as_tree(self)

    def _param(self):
        return next(self.parameters())

    # ------------------------------------------------------------------
    # encoder (whisper-style; stub embeddings in, contextual states out)
    # ------------------------------------------------------------------
    def _encode(self, params, audio_embed, tp=None):
        cfg = self.cfg
        positions = torch.arange(audio_embed.shape[1], dtype=torch.int32,
                                 device=audio_embed.device)

        def layer(pg, x):
            return apply_block(pg, cfg, x, "attn", "dense",
                               positions=positions, causal=False,
                               use_rope=False, tp=tp)[0]

        layer = _remat(layer, cfg.remat)
        x = audio_embed
        for pg in _unstack(params["encoder"]["body"], cfg.encoder_layers):
            x = layer(pg, x)
        return rmsnorm(x, params["encoder"]["final_norm"], cfg.norm_eps)

    # ------------------------------------------------------------------
    # embedding / input munging
    # ------------------------------------------------------------------
    def _embed(self, params, batch, positions, tp=None):
        cfg = self.cfg
        x = embed_tokens(params["embed"], batch["tokens"],
                         positions=positions if cfg.learned_pos else None,
                         tp=tp, vocab=cfg.padded_vocab)
        if cfg.frontend == "patch_stub" and "patch_embed" in batch:
            p = batch["patch_embed"].to(x.dtype)       # (B, P, D)
            x = torch.cat([p, x[:, p.shape[1]:]], dim=1)
        enc_out = None
        if cfg.encoder_layers and "audio_embed" in batch:
            enc_out = self._encode(params, batch["audio_embed"], tp)
        return shard_act(x, "batch", "seq", "embed"), enc_out

    # ------------------------------------------------------------------
    # layer stacks
    # ------------------------------------------------------------------
    def _run_stack(self, params, x, positions, *, causal=True, cache=None,
                   decode_pos=None, enc_out=None, collect_cache=False,
                   tp=None):
        aux = 0.0
        new_cache: Dict[str, Any] = {}
        decode = cache is not None and decode_pos is not None

        def run_one(pblock, x, kinds, c):
            return apply_block(pblock, self.cfg, x, *kinds,
                               positions=positions, causal=causal, cache=c,
                               decode_pos=decode_pos if decode else None,
                               enc_out=enc_out, use_rope=self.use_rope,
                               tp=tp)

        def run_ids(part, ids, x, aux):
            new_cache[part] = {}
            for i in ids:
                c = cache[part][str(i)] if decode else None
                x, nc, a = run_one(params[part][str(i)], x, self.kinds[i], c)
                aux = aux + a
                new_cache[part][str(i)] = _write_back(c, nc) if decode else nc
            return x, aux

        if self.prefix_ids:
            x, aux = run_ids("prefix", self.prefix_ids, x, aux)

        if self.n_groups:
            layers = _unstack(params["body"], self.n_groups)
            caches = (_unstack(cache["body"], self.n_groups) if decode
                      else [None] * self.n_groups)

            def group(pg, cg, x, aux):
                ncg = {}
                for p, kinds in enumerate(self.pattern_kinds):
                    ci = cg[str(p)] if cg is not None else None
                    x, nc, a = run_one(pg[str(p)], x, kinds, ci)
                    aux = aux + a
                    ncg[str(p)] = _write_back(ci, nc) if decode else nc
                return x, aux, ncg

            if not (decode or collect_cache):     # training / eval
                group = _remat(group, self.cfg.remat)
            group_caches = []
            for pg, cg in zip(layers, caches):
                x, aux, ncg = group(pg, cg, x, aux)
                group_caches.append(ncg)
            if decode:            # written into the stacked leaves' views
                new_cache["body"] = cache["body"]
            elif collect_cache:
                new_cache["body"] = tree_map(lambda *ls: torch.stack(ls),
                                             *group_caches)

        if self.tail_ids:
            x, aux = run_ids("tail", self.tail_ids, x, aux)

        return x, new_cache, aux

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def _tree(self, params):
        return self.param_tree() if params is None else params

    def _hidden(self, params, batch, tp):
        """The final-normed hidden states (B, S, D) and the MoE aux."""
        cfg = self.cfg
        s = batch["tokens"].shape[1]
        dev = batch["tokens"].device
        positions = torch.arange(s, dtype=torch.int32, device=dev)
        x, enc_out = self._embed(params, batch, positions, tp)
        x, _, aux = self._run_stack(params, x, positions, enc_out=enc_out,
                                    tp=tp)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return x, torch.zeros((), dtype=torch.float32, device=dev) + aux

    def _logits(self, params, x, tp):
        """The whole logits (B, S, vocab_size) on every rank (on ``tp``,
        each rank's vocabulary slice gathered)."""
        cfg = self.cfg
        logits = unembed(params["embed"], x, tp, cfg.padded_vocab)
        logits = T.gather(logits, tp, -1, cfg.padded_vocab, "logits")
        return logits[..., :cfg.vocab_size]

    def forward(self, batch, params=None, tp=None):
        """-> (logits (B,S,V), aux).  Training / teacher-forced eval."""
        params = self._tree(params)
        x, aux = self._hidden(params, batch, tp)
        return self._logits(params, x, tp), aux

    def loss(self, batch, aux_weight: float = 0.01, params=None, tp=None):
        """-> (ce + aux_weight * aux, {"ce", "aux"}).  On ``tp`` the cross
        entropy is vocabulary-parallel: no rank holds the whole logits."""
        cfg = self.cfg
        if T.splits(tp, cfg.padded_vocab):
            params = self._tree(params)
            x, aux = self._hidden(params, batch, tp)
            ce = cross_entropy_loss(
                unembed(params["embed"], x, tp, cfg.padded_vocab),
                batch["labels"], batch.get("loss_mask"), tp,
                cfg.vocab_size, cfg.padded_vocab)
        else:
            logits, aux = self.forward(batch, params, tp)
            ce = cross_entropy_loss(logits, batch["labels"],
                                    batch.get("loss_mask"))
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    @torch.inference_mode()
    def prefill(self, batch, max_len: Optional[int] = None, params=None,
                tp=None):
        """-> (last-position logits (B,1,V), cache sized for ``max_len``)."""
        cfg = self.cfg
        params = self._tree(params)
        b, s = batch["tokens"].shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=batch["tokens"].device)
        x, enc_out = self._embed(params, batch, positions, tp)
        x, cache, _ = self._run_stack(params, x, positions, enc_out=enc_out,
                                      collect_cache=True, tp=tp)
        x = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x, tp)
        if max_len is not None and max_len > s:
            leaf = params["final_norm"]
            full = self.init_cache(b, max_len,
                                   enc_len=(enc_out.shape[1]
                                            if enc_out is not None else 0),
                                   dtype=leaf.dtype, device=leaf.device,
                                   tp=tp)
            cache = _merge_cache(full, cache)
        return logits, cache

    @torch.inference_mode()
    def decode_step(self, cache, tokens, pos: int, params=None, tp=None):
        """tokens (B,1), pos an int -> (logits (B,1,V), cache).  The cache
        is updated in place (the reference donates it) and returned."""
        params = self._tree(params)
        pos = int(pos)
        positions = torch.arange(pos, pos + 1, dtype=torch.int32,
                                 device=tokens.device)
        x, _ = self._embed(params, {"tokens": tokens}, positions, tp)
        x, new_cache, _ = self._run_stack(params, x, positions, cache=cache,
                                          decode_pos=pos, tp=tp)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return self._logits(params, x, tp), new_cache

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_shapes(self, batch: int, max_len: int, enc_len: int = 0,
                     tp=None):
        """The cache tree's shapes; on ``tp`` this rank's (the dimensions
        of ``CACHE_MODEL_DIMS`` the axis divides, split)."""
        cfg = self.cfg
        enc_len = enc_len or (cfg.encoder_seq if cfg.encoder_layers else 0)

        def local(name, sh):
            dim = CACHE_MODEL_DIMS.get(name)
            if dim is None or not T.splits(tp, sh[dim]):
                return sh
            return sh[:dim] + (sh[dim] // tp.size,) + sh[dim + 1:]

        def one(blk):
            return _map_shapes(local, block_cache_shapes(
                cfg, blk, self.cross, batch, max_len, enc_len))

        tree: Dict[str, Any] = {}
        if self.prefix_ids:
            tree["prefix"] = {str(i): one(self.kinds[i][0])
                              for i in self.prefix_ids}
        if self.n_groups:
            tree["body"] = {
                str(p): _map_shapes(lambda _n, sh: (self.n_groups,) + sh,
                                    one(self.pattern_kinds[p][0]))
                for p in range(len(self.pattern_kinds))}
        if self.tail_ids:
            tree["tail"] = {str(i): one(self.kinds[i][0])
                            for i in self.tail_ids}
        return tree

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0,
                   dtype=None, device=None, tp=None):
        """Zero caches: ``h`` / ``ssm`` leaves float32, the others
        ``dtype`` (default: the parameters' dtype), on ``device``
        (default: the parameters' device); on ``tp`` this rank's."""
        dtype = dtype or self._param().dtype
        device = device or self._param().device
        return _map_shapes(
            lambda name, sh: torch.zeros(
                sh, dtype=torch.float32 if name in ("h", "ssm") else dtype,
                device=device),
            self.cache_shapes(batch, max_len, enc_len, tp))


def _merge_cache(full, prefill):
    """Write a prefill cache into a zero-initialised ``max_len`` cache.

    A local-attention ring that prefill padded to ``window`` is longer
    than a cache of ``max_len < window`` slots; only padding lies past
    ``max_len`` (prefill had fewer tokens), so it is cropped.  (The
    reference's ``dynamic_update_slice`` raises there.)
    """

    def merge(f, p):
        if f.shape == p.shape:
            return p.to(f.dtype)
        idx = tuple(slice(0, min(a, b)) for a, b in zip(f.shape, p.shape))
        f[idx] = p[idx].to(f.dtype)
        return f

    return tree_map(merge, full, prefill)
