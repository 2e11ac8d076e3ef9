"""Measure SGD-update formulations on the attached device at the
R-MG-34 parameter tree (299 leaves, ~32.9M params).

The update moves 5 x 131.6 MB of f32 (read p/m/g, write p/m) — about
0.2 ms at the H100's 3.35 TB/s — so time above that floor is per-kernel
overhead across 299 small leaves (not measured on the H100 yet).
Candidates:

  tree      - the shipped per-leaf update (`mgtpu/train/optim.py`)
  bucketed  - leaves below a size threshold are ravel-concatenated and
              updated in ONE fused kernel (classic multi-tensor apply);
              big conv kernels stay per-leaf
  flat      - everything concatenated into one vector (risk: XLA may
              materialize the 131 MB concats, adding traffic)

Usage: python tools/bench_sgd.py  [-v]   (run without other load on
the device)
"""

import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def _sync(tree):
    return jax.block_until_ready(tree)


def time_update(fn, params, grads, m, iters=30, warmup=5):
    f = jax.jit(fn, donate_argnums=(0, 2))
    p, mm = params, m
    for _ in range(warmup):
        p, mm = f(p, grads, mm)
    _sync(p)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            p, mm = f(p, grads, mm)
        _sync(p)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best, (p, mm)


def update_tree(lr, wd, mu):
    def fn(params, grads, m):
        def upd(p, g, mv):
            g = g + wd * p
            mv = mu * mv + g
            return p - lr * mv, mv

        out = jax.tree.map(upd, params, grads, m)
        new_p = jax.tree.map(lambda t: t[0], out, is_leaf=lambda t: isinstance(t, tuple))
        new_m = jax.tree.map(lambda t: t[1], out, is_leaf=lambda t: isinstance(t, tuple))
        return new_p, new_m

    return fn


def update_bucketed(lr, wd, mu, threshold):
    def fn(params, grads, m):
        flat_p, treedef = jax.tree.flatten(params)
        flat_g = jax.tree.leaves(grads)
        flat_m = jax.tree.leaves(m)
        small = [i for i, l in enumerate(flat_p) if l.size < threshold]
        new_p, new_m = list(flat_p), list(flat_m)
        if small:
            sp = jnp.concatenate([flat_p[i].ravel() for i in small])
            sg = jnp.concatenate([flat_g[i].ravel() for i in small])
            sm = jnp.concatenate([flat_m[i].ravel() for i in small])
            sg = sg + wd * sp
            sm = mu * sm + sg
            sp = sp - lr * sm
            offs = np.cumsum([flat_p[i].size for i in small])[:-1]
            for i, pv, mv in zip(small, jnp.split(sp, offs), jnp.split(sm, offs)):
                new_p[i] = pv.reshape(flat_p[i].shape)
                new_m[i] = mv.reshape(flat_m[i].shape)
        for i, l in enumerate(flat_p):
            if l.size >= threshold:
                g = flat_g[i] + wd * l
                mv = mu * flat_m[i] + g
                new_p[i] = l - lr * mv
                new_m[i] = mv
        return jax.tree.unflatten(treedef, new_p), jax.tree.unflatten(treedef, new_m)

    return fn


def main():
    from mgtpu.models import get_net
    from mgtpu.train.optim import sgd_init

    opt = types.SimpleNamespace(depth=34, compute_dtype=jnp.bfloat16)
    net = get_net("ilsvrc/rnmg")
    model = net.create_model(opt)
    params, _ = jax.jit(model.init)(jax.random.PRNGKey(0))
    m0 = sgd_init(params)["m"]
    grads = jax.tree.map(lambda p: jnp.full_like(p, 1e-4), params)
    leaves = jax.tree.leaves(params)
    n_par = sum(l.size for l in leaves)
    print(f"leaves={len(leaves)} params={n_par/1e6:.2f}M "
          f"traffic={5*4*n_par/1e6:.0f}MB/step")

    lr, wd, mu = 0.1, 1e-4, 0.9
    t_tree, (p1, m1) = time_update(update_tree(lr, wd, mu),
                                   jax.tree.map(jnp.copy, params), grads,
                                   jax.tree.map(jnp.copy, m0))
    results = {"tree": t_tree}
    ref_after_1 = None
    for thr_log2 in (13, 15, 17, 31):
        name = "flat" if thr_log2 == 31 else f"bucket<2^{thr_log2}"
        fn = update_bucketed(lr, wd, mu, 1 << thr_log2)
        t, (p2, m2) = time_update(fn, jax.tree.map(jnp.copy, params), grads,
                                  jax.tree.map(jnp.copy, m0))
        results[name] = t
        # numerics: one step from identical state must match the tree path
        pa, _ = update_tree(lr, wd, mu)(jax.tree.map(jnp.copy, params), grads,
                                        jax.tree.map(jnp.copy, m0))
        pb, _ = fn(jax.tree.map(jnp.copy, params), grads,
                   jax.tree.map(jnp.copy, m0))
        err = max(float(jnp.max(jnp.abs(a - b)))
                  for a, b in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)))
        print(f"{name:>14}: {t*1e3:8.3f} ms   max|dp|={err:.2e}")
    print(f"{'tree':>14}: {t_tree*1e3:8.3f} ms   (shipped)")
    best = min(results, key=results.get)
    print(f"best: {best}  ({results[best]*1e3:.3f} ms vs tree {t_tree*1e3:.3f} ms)")


if __name__ == "__main__":
    main()
