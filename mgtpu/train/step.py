"""Jitted train/test steps.

The rebuild of the reference's hot loop (`pipelines/standard/train.lua:
124-207` trainBatch): forward+loss+backward (NETOBJ.ftrain), gradient
accumulation over `-iterSize` micro-batches (criterion pre-scaled
1/iterSize, `model.lua:38-44` — here a lax.scan computing the mean
gradient), then one SGD update. Under a data-parallel mesh the batch dim
is sharded and XLA all-reduces gradients (NCCL on GPUs); there is no
syncParameters step (params stay replicated).

BN running stats thread through micro-batches sequentially, matching
the reference's per-micro-batch forward."""

from __future__ import annotations


import jax
import jax.numpy as jnp


def make_train_step(model, loss_fn, net, iter_size: int = 1, momentum: float = 0.9,
                    remat: bool = False, bucket_sgd: bool = True,
                    zero1: bool = False, log_grad_norm: bool = False):
    """Returns train_step(params, stats, opt_state, batch, lr, wd, rng)
    -> (params, stats, opt_state, metrics).

    batch = {"x": ..., "y": ...}; with iter_size > 1 the leading axis of
    each entry is (iter_size, batch, ...). ``remat`` rematerializes the
    forward during the backward pass (jax.checkpoint) — slower but fits
    larger per-chip batches in HBM. ``zero1`` pins the updated momentum
    back to its ZeRO-1 'data'-axis sharding (mgtpu.parallel.zero1_spec)
    and the updated params to replicated: without the constraints GSPMD
    would propagate the momentum's layout into the params, and every
    conv of the NEXT step would pay a per-use all-gather of its kernel.

    ``log_grad_norm`` (the -logGradNorm CLI flag) adds three diagnostic
    metrics per step: ``gradnorm`` = global L2 of the raw gradients
    (before the coupled weight-decay term), ``pnorm`` = global L2 of
    the params AFTER the update, and ``maxupd`` = max |param change| of
    the step. On a BN (scale-invariant) network the effective LR is
    ~ lr/||w||^2, so a steadily decaying pnorm with a flat lr predicts
    an effective-LR blowup — the instrumentation for the LR-0.1 loss
    spikes seen in long constant-LR runs (PARITY.md).
    """
    from mgtpu.train.optim import sgd_update

    def loss_and_metrics(params, stats, x, y, rng):
        out, new_stats = model.apply(params, stats, x, train=True, rng=rng)
        loss = loss_fn(out, y)
        metrics = net.train_metrics(out, y, loss)
        return loss, (new_stats, metrics)

    if remat:
        loss_and_metrics = jax.checkpoint(loss_and_metrics)

    grad_fn = jax.grad(loss_and_metrics, has_aux=True)

    def train_step(params, stats, opt_state, batch, lr, wd, rng):
        if iter_size == 1:
            grads, (stats, metrics) = grad_fn(params, stats, batch["x"], batch["y"], rng)
        else:
            def micro(carry, xs):
                st, acc = carry
                x, y, k = xs
                g, (st, m) = grad_fn(params, st, x, y, k)
                acc = jax.tree.map(lambda a, b: a + b, acc, g)
                return (st, acc), m

            zero = jax.tree.map(jnp.zeros_like, params)
            keys = jax.random.split(rng, iter_size)
            (stats, gsum), ms = jax.lax.scan(
                micro, (stats, zero), (batch["x"], batch["y"], keys)
            )
            grads = jax.tree.map(lambda g: g / iter_size, gsum)
            metrics = jax.tree.map(jnp.mean, ms)
        if log_grad_norm:
            metrics = dict(metrics)
            metrics["gradnorm"] = jnp.sqrt(sum(
                jnp.sum(jnp.square(g.astype(jnp.float32)))
                for g in jax.tree.leaves(grads)
            ))
        old_params = params if log_grad_norm else None
        params, opt_state = sgd_update(
            params, grads, opt_state, lr, wd, momentum, bucket=bucket_sgd
        )
        if log_grad_norm:
            metrics["pnorm"] = jnp.sqrt(sum(
                jnp.sum(jnp.square(p.astype(jnp.float32)))
                for p in jax.tree.leaves(params)
            ))
            metrics["maxupd"] = jnp.max(jnp.stack([
                jnp.max(jnp.abs(n.astype(jnp.float32) - o.astype(jnp.float32)))
                for n, o in zip(jax.tree.leaves(params),
                                jax.tree.leaves(old_params))
            ]))
        if zero1:
            from jax.sharding import PartitionSpec as P

            from mgtpu.parallel.mesh import zero1_spec

            mesh = jax.sharding.get_abstract_mesh()
            nd = mesh.shape.get("data", 1) if mesh is not None else 1
            if nd > 1:
                params = jax.tree.map(
                    lambda p: jax.lax.with_sharding_constraint(p, P()), params
                )
                opt_state = jax.tree.map(
                    lambda m: jax.lax.with_sharding_constraint(
                        m, zero1_spec(m, nd)
                    ),
                    opt_state,
                )
        return params, stats, opt_state, metrics

    return train_step


def make_eval_step(model, loss_fn, net, mode: str = "test"):
    """Returns eval_step(params, stats, batch) -> metrics dict (+ raw
    outputs for stored dumps). Eval mode: BN running stats, no dropout
    (reference NETOBJ.ftest, `models/basic_model.lua:68-72`)."""

    metrics_fn = net.test_metrics if mode == "test" else net.eval_metrics

    def eval_step(params, stats, batch):
        out, _ = model.apply(params, stats, batch["x"], train=False)
        loss = loss_fn(out, batch["y"])
        return metrics_fn(out, batch["y"], loss), out

    return eval_step


def make_tencrop_eval_step(model, loss_fn, net, mode: str = "test"):
    """10-crop evaluation: batch x is (N, 10, H, W, C); forward all
    crops, average the class PROBABILITIES across crops (fb.resnet
    convention behind the reference's 10-crop ImageNet numbers,
    `README.md:105-109`; the loader path is `dataset/ilsvrc/
    donkey.lua:102-112`), and compute loss/metrics on the log of the
    crop-mean distribution."""

    metrics_fn = net.test_metrics if mode == "test" else net.eval_metrics

    def eval_step(params, stats, batch):
        x, y = batch["x"], batch["y"]
        n, k = x.shape[0], x.shape[1]
        out, _ = model.apply(
            params, stats, x.reshape((n * k,) + x.shape[2:]), train=False
        )
        # log(mean_k exp(out)) via logsumexp — exp() alone underflows
        # for confident log-probs
        out = out.astype(jnp.float32).reshape(n, k, -1)
        log_mean = jax.nn.logsumexp(out, axis=1) - jnp.log(float(k))
        loss = loss_fn(log_mean, y)
        return metrics_fn(log_mean, y, loss), log_mean

    return eval_step
