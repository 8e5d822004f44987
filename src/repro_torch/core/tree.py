"""Parameter trees (nested dicts and lists of tensors), as the reference
keeps them: map over leaves, flatten in ``jax.tree.leaves`` order (dict
keys sorted), and take a loss's gradient with respect to a whole tree."""
from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *u) for u in zip(*trees)]
    return fn(*trees)


def leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree, new_leaves: list):
    """``tree``'s structure holding ``new_leaves`` (in ``leaves`` order)."""
    it = iter(new_leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return next(it)
    return fill(tree)


def value_and_grad(loss_fn, params):
    """(loss, gradient tree) of the scalar ``loss_fn(params)``, as
    ``jax.value_and_grad``; neither is read back to the host."""
    ls = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, ls))
        grads = torch.autograd.grad(loss, ls)
    return loss.detach(), unflatten(params, list(grads))
