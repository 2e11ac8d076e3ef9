"""SGD with momentum and *coupled* weight decay — exact semantics of
torch `optim.sgd` as driven by the reference
(`models/basic_model.lua:64-66`, `pipelines/standard/train.lua:49-55`):

    g  <- g + wd * p          (L2 added into the gradient)
    m  <- mu * m + g          (dampening 0, no nesterov)
    p  <- p - lr * m

momentum 0.9 (`opts.lua:43`). lr/wd are traced scalars so epoch changes
don't recompile. Unlike the reference — which rebuilds optimState every
epoch, dropping momentum (`train.lua:48-55`) — the momentum buffer here
persists across epochs and is checkpointed; pass ``reset_momentum``
per-epoch to reproduce the reference exactly."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Leaves below this many elements are ravel-concatenated and updated in
# one fused kernel (multi-tensor apply). R-MG-34's tree is 302 leaves
# but only ~40 are real conv kernels; the rest are small BN/bias
# vectors whose per-fusion launch overhead dominates their bandwidth.
# The threshold was tuned on the accelerator the project was first built
# for, where larger buckets lost (XLA materialized the multi-MB
# concats); it is not yet measured on the GPU (tools/bench_sgd.py races
# the candidates).
_BUCKET_THRESHOLD = 1 << 13


def sgd_init(params):
    return {"m": jax.tree.map(jnp.zeros_like, params)}


def sgd_update(params, grads, state, lr, wd, momentum: float = 0.9,
               bucket: bool = True):
    """``bucket=False`` disables the multi-tensor path — required under
    tensor parallelism, where concatenating channel-sharded BN vectors
    would force all-gathers inside the update."""

    def upd(p, g, m):
        g = g + wd * p
        m = momentum * m + g
        return p - lr * m, m

    flat_p, treedef = jax.tree.flatten(params)
    flat_g = jax.tree.leaves(grads)
    flat_m = jax.tree.leaves(state["m"])
    new_p, new_m = list(flat_p), list(flat_m)
    small = [i for i, l in enumerate(flat_p)
             if bucket and l.size < _BUCKET_THRESHOLD
             and l.dtype == flat_p[0].dtype]
    if len(small) > 1:
        sp, sm = upd(
            jnp.concatenate([flat_p[i].ravel() for i in small]),
            jnp.concatenate([flat_g[i].ravel() for i in small]),
            jnp.concatenate([flat_m[i].ravel() for i in small]),
        )
        offs = np.cumsum([flat_p[i].size for i in small])[:-1]
        for i, pv, mv in zip(small, jnp.split(sp, offs), jnp.split(sm, offs)):
            new_p[i] = pv.reshape(flat_p[i].shape)
            new_m[i] = mv.reshape(flat_m[i].shape)
        small_set = set(small)
    else:
        small_set = set()
    for i, l in enumerate(flat_p):
        if i not in small_set:
            new_p[i], new_m[i] = upd(l, flat_g[i], flat_m[i])
    return (jax.tree.unflatten(treedef, new_p),
            {"m": jax.tree.unflatten(treedef, new_m)})


def reset_momentum(state):
    """Reproduce the reference's per-epoch optimState rebuild —
    reachable from the CLI via -resetMomentum (standard.py:train)."""
    return {"m": jax.tree.map(jnp.zeros_like, state["m"])}
