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
    return _fill(tree, iter(new_leaves))


def _fill(t, it):
    # a module-level function: a nested one that calls itself is a
    # reference cycle through its closure, which kept the iterator, and so
    # every leaf (a whole gradient tree), alive until the garbage
    # collector's next full pass
    if isinstance(t, dict):
        return {k: _fill(t[k], it) for k in sorted(t)}
    if isinstance(t, list):
        return [_fill(v, it) for v in t]
    return next(it)


def value_and_grad(loss_fn, params, has_aux: bool = False):
    """(loss, gradient tree) of the scalar ``loss_fn(params)``, as
    ``jax.value_and_grad``; neither is read back to the host. With
    ``has_aux``, ``loss_fn`` returns (loss, aux) and the result is
    ((loss, aux), gradient tree), aux's tensors detached. Every leaf must
    reach the loss (autograd raises for one that does not)."""
    ls = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        out = loss_fn(unflatten(params, ls))
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, ls)
    grads = unflatten(params, list(grads))
    if has_aux:
        return (loss.detach(), tree_map(torch.Tensor.detach, out[1])), grads
    return loss.detach(), grads
