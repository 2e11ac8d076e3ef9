"""Differential train-step cost breakdown for R-MG-34 on the attached
device: times (1) eval-mode forward, (2) train-mode forward (adds BN
batch moments), (3) fwd+bwd grad, (4) full fwd+bwd+sgd step. The deltas
attribute the train-step overhead vs the inference headline without a
trace.

Usage: python tools/bench_step_breakdown.py [batch]
"""

import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def timeit(fn, args, iters=20, warmup=3, donate=None):
    f = jax.jit(fn, donate_argnums=donate) if donate else jax.jit(fn)
    out = None
    for _ in range(warmup):
        out = f(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 128

    from mgtpu.models import get_net
    from mgtpu.train.optim import sgd_init, sgd_update
    from mgtpu.train.step import make_train_step

    opt = types.SimpleNamespace(depth=34, compute_dtype=jnp.bfloat16)
    net = get_net("ilsvrc/rnmg")
    model = net.create_model(opt)
    loss_fn = net.create_loss(opt)
    params, stats = jax.jit(model.init)(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (batch, 224, 224, 3), jnp.bfloat16)
    y = (jax.random.uniform(jax.random.PRNGKey(2), (batch,)) * 1000).astype(jnp.int32)
    rng = jax.random.PRNGKey(3)

    def fwd_eval(p, s, x):
        out, _ = model.apply(p, s, x, train=False)
        return jnp.sum(out.astype(jnp.float32))

    def fwd_train(p, s, x, k):
        out, ns = model.apply(p, s, x, train=True, rng=k)
        return jnp.sum(out.astype(jnp.float32)), ns

    def loss_f(p, s, x, y, k):
        out, ns = model.apply(p, s, x, train=True, rng=k)
        return loss_fn(out, y), ns

    grad_f = jax.grad(loss_f, has_aux=True)

    def fwd_bwd(p, s, x, y, k):
        g, ns = grad_f(p, s, x, y, k)
        return g, ns

    step = make_train_step(model, loss_fn, net, iter_size=1)
    opt_state = sgd_init(params)

    t_eval = timeit(fwd_eval, (params, stats, x))
    t_train = timeit(fwd_train, (params, stats, x, rng))
    t_grad = timeit(fwd_bwd, (params, stats, x, y, rng))
    t_step = timeit(
        lambda p, s, o, b, k: step(p, s, o, b, 0.1, 1e-4, k),
        (params, stats, opt_state, {"x": x, "y": y}, rng),
    )

    us = lambda t: t / batch * 1e6
    print(f"batch {batch}")
    print(f"fwd eval          : {t_eval*1e3:8.2f} ms  {us(t_eval):7.1f} us/img  {batch/t_eval:8.0f} img/s")
    print(f"fwd train (BN/mom): {t_train*1e3:8.2f} ms  {us(t_train):7.1f} us/img  (+{us(t_train-t_eval):.1f})")
    print(f"fwd+bwd           : {t_grad*1e3:8.2f} ms  {us(t_grad):7.1f} us/img  (+{us(t_grad-t_train):.1f} bwd)")
    print(f"full step (+sgd)  : {t_step*1e3:8.2f} ms  {us(t_step):7.1f} us/img  (+{us(t_step-t_grad):.1f} sgd)  {batch/t_step:8.0f} img/s")
    print(f"bwd/fwd ratio     : {(t_grad-t_train)/t_eval:.2f}x (ideal ~2x)")


if __name__ == "__main__":
    main()
