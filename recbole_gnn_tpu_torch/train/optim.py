"""Optimizers — functional updates on nested dicts / lists of tensors.

Port of ``recbole_gnn_tpu/train/optim.py``: the [recbole] ``learner``
values (adam default; sgd / adagrad / rmsprop), global-norm gradient
clipping (``clip_grad_norm``) and L2 weight decay added to the
gradients *before* the moment updates — coupled ``torch.optim.Adam``
semantics, not decoupled AdamW.

Not ``torch.optim``: the state keeps the JAX package's layout —
``{"m", "v", "t"}`` for Adam with ``t`` a 0-d int32 tensor (counted
up in place),
``{"acc"}`` for adagrad, ``{"v"}`` for rmsprop, ``{}`` for sgd — so a
checkpoint cross-loads between the two packages, and the clip divides
by ``max(gnorm, 1e-12)`` (``torch.nn.utils.clip_grad_norm_`` adds
1e-6).  ``update`` works **in place**, under ``torch.no_grad()``: it
overwrites the param and state tensors it is given and returns the
same dicts, so a step allocates no second copy of the tables.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params) → (params, state), both updated in place
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves of a nested dict / list / tuple in JAX's order: dict keys
    sorted, sequences in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(like, leaves: list):
    """A tree shaped like ``like`` holding ``leaves`` (``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _clip_by_global_norm(grads: list[torch.Tensor], max_norm: float
                         ) -> list[torch.Tensor]:
    gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return [g * scale for g in grads]


def make_optimizer(learner: str = "adam", lr: float = 1e-3,
                   weight_decay: float = 0.0,
                   clip_grad_norm: float | None = None,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> Optimizer:
    learner = (learner or "adam").lower()

    def preprocess(grads, params) -> list[torch.Tensor]:
        g = tree_leaves(grads)
        if clip_grad_norm:
            g = _clip_by_global_norm(g, clip_grad_norm)
        if weight_decay:
            g = [g_ + weight_decay * p for g_, p in zip(g, tree_leaves(params))]
        return g

    def zeros(params):
        return tree_map(torch.zeros_like, params)

    if learner == "adam":
        def init(params):
            dev = tree_leaves(params)[0].device
            return {"m": zeros(params), "v": zeros(params),
                    "t": torch.zeros((), dtype=torch.int32, device=dev)}

        def update(grads, state, params):
            with torch.no_grad():
                gs = preprocess(grads, params)
                # the step count in place, so that the state's tensors
                # stay the same objects step after step (a captured step
                # replays reads and writes of the same memory)
                t = state["t"].add_(1)
                tf = t.to(torch.float32)
                # bias corrections in float32, as the JAX package does
                bc1 = 1 - torch.full((), b1, dtype=torch.float32,
                                     device=t.device) ** tf
                bc2 = 1 - torch.full((), b2, dtype=torch.float32,
                                     device=t.device) ** tf
                for p, g, m, v in zip(tree_leaves(params), gs,
                                      tree_leaves(state["m"]),
                                      tree_leaves(state["v"])):
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
            return params, state

    elif learner == "sgd":
        def init(params):
            return {}

        def update(grads, state, params):
            with torch.no_grad():
                for p, g in zip(tree_leaves(params), preprocess(grads, params)):
                    p.sub_(lr * g)
            return params, state

    elif learner == "adagrad":
        def init(params):
            return {"acc": zeros(params)}

        def update(grads, state, params):
            with torch.no_grad():
                for p, g, a in zip(tree_leaves(params),
                                   preprocess(grads, params),
                                   tree_leaves(state["acc"])):
                    a.add_(g * g)
                    p.sub_(lr * g / (torch.sqrt(a) + 1e-10))
            return params, state

    elif learner == "rmsprop":
        def init(params):
            return {"v": zeros(params)}

        def update(grads, state, params):
            with torch.no_grad():
                for p, g, v in zip(tree_leaves(params),
                                   preprocess(grads, params),
                                   tree_leaves(state["v"])):
                    v.mul_(0.99).add_(0.01 * g * g)
                    p.sub_(lr * g / (torch.sqrt(v) + 1e-8))
            return params, state

    else:
        raise ValueError(f"unknown learner {learner!r}")

    return Optimizer(init=init, update=update)
