import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgtpu.ops.mg import (
    MgConv,
    MgConvInput,
    MgPool,
    MgResidual,
    MgStem7x7,
    MgUpConv,
    resample_concat,
    pyramid_widths_after_exchange,
)


def _pyr(b, hws, cs, key=0):
    rng = np.random.RandomState(key)
    return tuple(
        jnp.asarray(rng.randn(b, h, w, c).astype(np.float32))
        for (h, w), c in zip(hws, cs)
    )


def test_exchange_widths():
    # channel counts after ResampleConcat: c[i-1]+c[i]+c[i+1]
    # (reference pnmg.lua:53-77)
    assert pyramid_widths_after_exchange([40, 40, 40]) == [80, 120, 80]
    assert pyramid_widths_after_exchange([64, 32, 16]) == [96, 112, 48]
    assert pyramid_widths_after_exchange([512]) == [512]


def test_resample_concat_shapes():
    pyr = _pyr(2, [(8, 8), (4, 4), (2, 2)], [4, 6, 8])
    out = resample_concat(pyr)
    assert out[0].shape == (2, 8, 8, 10)  # 4 + 6(up)
    assert out[1].shape == (2, 4, 4, 18)  # 4(down) + 6 + 8(up)
    assert out[2].shape == (2, 2, 2, 14)  # 6(down) + 8


def test_resample_concat_values():
    # single channel per scale, verify the concat order: down|same|up
    pyr = _pyr(1, [(4, 4), (2, 2)], [1, 1])
    out = resample_concat(pyr)
    fine, coarse = np.asarray(pyr[0]), np.asarray(pyr[1])
    # scale 0: [self, up(coarse)]
    np.testing.assert_allclose(np.asarray(out[0])[..., 0], fine[..., 0])
    np.testing.assert_allclose(
        np.asarray(out[0])[0, :, :, 1], np.repeat(np.repeat(coarse[0, :, :, 0], 2, 0), 2, 1)
    )
    # scale 1: [down(fine), self]
    np.testing.assert_allclose(np.asarray(out[1])[..., 1], coarse[..., 0])
    down = np.asarray(out[1])[0, :, :, 0]
    expect = fine[0].reshape(2, 2, 2, 2, 1).max(axis=(1, 3))[..., 0]
    np.testing.assert_allclose(down, expect)


def _run(block, pyr, train=False):
    params, stats = jax.jit(block.init)(jax.random.PRNGKey(0))
    out, new_stats = jax.jit(
        lambda p, s, x, k: block.apply(p, s, x, train=train, rng=k)
    )(params, stats, pyr, jax.random.PRNGKey(1))
    return out, params, new_stats


def test_mg_conv_input():
    block = MgConvInput([40, 40, 40], eps=1e-3)
    x = jnp.ones((2, 32, 32, 3))
    out, _, _ = _run(block, x)
    assert [o.shape for o in out] == [
        (2, 32, 32, 40),
        (2, 16, 16, 40),
        (2, 8, 8, 40),
    ]


def test_mg_conv():
    block = MgConv([40, 40, 40], [80, 40, 40], [3, 3, 3])
    pyr = _pyr(2, [(32, 32), (16, 16), (8, 8)], [40, 40, 40])
    out, _, _ = _run(block, pyr)
    assert [o.shape[-1] for o in out] == [80, 40, 40]
    assert [o.shape[1] for o in out] == [32, 16, 8]


def test_mg_conv_kernel1_no_pad():
    block = MgConv([320, 160, 80], [320, 160, 80], [3, 3, 1])
    pyr = _pyr(1, [(4, 4), (2, 2), (1, 1)], [320, 160, 80])
    out, _, _ = _run(block, pyr)
    assert [o.shape[1] for o in out] == [4, 2, 1]


def test_mg_residual_identity_and_pad():
    # widening -> zero-pad shortcut; same widths -> identity
    block = MgResidual([40, 20, 10], [80, 40, 20])
    pyr = _pyr(2, [(32, 32), (16, 16), (8, 8)], [40, 20, 10])
    out, _, _ = _run(block, pyr)
    assert [o.shape[-1] for o in out] == [80, 40, 20]
    # all outputs post-ReLU nonnegative
    assert all(float(jnp.min(o)) >= 0.0 for o in out)


def test_mg_residual_shortcut_types():
    for st, has_conv in (("A", False), ("B", True), ("C", True)):
        block = MgResidual([40, 20], [80, 40], shortcut_type=st)
        if has_conv:
            assert all(sc is not None for sc in block.shortcuts)
        else:
            assert all(sc is None for sc in block.shortcuts)
    # narrowing under A falls back to 1x1 conv (prnmg.mnist.lua:13-25)
    block = MgResidual([80, 40], [40, 20], shortcut_type="A")
    assert all(sc is not None for sc in block.shortcuts)


def test_mg_pool_modes():
    pyr = _pyr(1, [(8, 8), (4, 4), (2, 2)], [320, 160, 80])
    plain = MgPool([320, 160, 80], "plain")
    out, _, _ = _run(plain, pyr)
    assert [o.shape[1:] for o in out] == [(4, 4, 320), (2, 2, 160), (1, 1, 80)]
    assert plain.out_widths == [320, 160, 80]

    concat = MgPool([320, 160, 80], "concat")
    out, _, _ = _run(concat, pyr)
    assert [o.shape[1:] for o in out] == [(4, 4, 320), (2, 2, 240)]
    assert concat.out_widths == [320, 240]

    drop = MgPool([320, 160, 80], "drop")
    out, _, _ = _run(drop, pyr)
    assert [o.shape[1:] for o in out] == [(4, 4, 320), (2, 2, 160)]
    assert drop.out_widths == [320, 160]


def test_mg_stem7x7():
    block = MgStem7x7([64, 32, 16])
    x = jnp.ones((1, 224, 224, 3))
    out, _, _ = _run(block, x)
    assert [o.shape[1:] for o in out] == [
        (56, 56, 64),
        (28, 28, 32),
        (14, 14, 16),
    ]


def test_mg_upconv():
    block = MgUpConv([128, 64], [64, 32])
    pyr = _pyr(1, [(8, 8), (4, 4)], [128, 64])
    out, _, _ = _run(block, pyr)
    assert [o.shape[1:] for o in out] == [(16, 16, 64), (8, 8, 32)]


def test_bn_stats_update_in_train():
    block = MgConv([8, 8], [8, 8])
    pyr = _pyr(2, [(8, 8), (4, 4)], [8, 8])
    params, stats = block.init(jax.random.PRNGKey(0))
    _, s_eval = block.apply(params, stats, pyr, train=False)
    _, s_train = block.apply(params, stats, pyr, train=True)
    before = stats["0"]["bn"]["mean"]
    assert np.allclose(np.asarray(s_eval["0"]["bn"]["mean"]), np.asarray(before))
    assert not np.allclose(np.asarray(s_train["0"]["bn"]["mean"]), np.asarray(before))


def test_grads_flow():
    block = MgResidual([8, 8], [8, 8])
    pyr = _pyr(2, [(8, 8), (4, 4)], [8, 8])
    params, stats = block.init(jax.random.PRNGKey(0))

    def loss(p):
        out, _ = block.apply(p, stats, pyr, train=True)
        return sum(jnp.sum(o**2) for o in out)

    g = jax.grad(loss)(params)
    norms = [float(jnp.abs(x).sum()) for x in jax.tree.leaves(g)]
    assert all(np.isfinite(norms))
    assert sum(n > 0 for n in norms) > len(norms) * 0.5


def test_bn_custom_vjp_matches_naive_autodiff(monkeypatch):
    """The train-mode BN uses a custom VJP (one-pass moments, canonical
    2-reduction backward, nn.py:_bn_train) — value, all gradients, and
    the running-stat update must match the naive autodiff formulation
    to fp32 tolerance."""
    import os

    from mgtpu.nn import BatchNorm

    bn = BatchNorm(8, eps=1e-5)
    _, s = bn.init(jax.random.PRNGKey(0))
    p = {
        "scale": jax.random.uniform(jax.random.PRNGKey(0), (8,), jnp.float32, 0.5, 1.5),
        "bias": jax.random.normal(jax.random.PRNGKey(1), (8,)),
    }
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 5, 5, 8), jnp.float32) * 3 + 1.5

    def run():
        def loss(p, x):
            y, ns = bn.apply(p, s, x, train=True)
            return jnp.sum(jnp.sin(y)), ns

        (l, ns), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x)
        return l, g, ns

    monkeypatch.setenv("MGTPU_BN_NAIVE", "1")
    l1, g1, ns1 = run()
    monkeypatch.delenv("MGTPU_BN_NAIVE")
    l2, g2, ns2 = run()

    assert abs(float(l1) - float(l2)) < 1e-4
    for k in ("scale", "bias"):
        np.testing.assert_allclose(g1[0][k], g2[0][k], atol=1e-4)
    np.testing.assert_allclose(g1[1], g2[1], atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ns1[k], ns2[k], atol=1e-5)

    yb, nsb = bn.apply(p, s, x.astype(jnp.bfloat16), train=True)
    assert yb.dtype == jnp.bfloat16 and nsb["mean"].dtype == jnp.float32


def test_bce_loss_saturated_sigmoid_finite():
    """bce_loss must stay finite (value AND grad) for saturated and
    even slightly-out-of-range sigmoid outputs. Two failure modes are
    pinned (see bce_loss docstring; both once bit prnmg.mnist.sh step 1
    on the accelerator the project was first built for): (a) clip(p,
    eps, 1-eps) no-ops at the top in f32 (1 - 1e-12 == 1.0) -> log(0);
    (b) a fused logistic+log chain can push 1 - sigmoid(z) NEGATIVE
    under jit -> log(neg) = NaN,
    and 0 * NaN = NaN so the zero target doesn't mask it. The
    maximum(., eps) guard survives both."""
    from mgtpu.models.base import bce_loss

    p = jnp.array([0.0, 1.0, 0.5], jnp.float32)
    t = jnp.array([1.0, 0.0, 0.5], jnp.float32)
    l = bce_loss(p, t)
    assert np.isfinite(float(l)), float(l)
    # THNN-parity value: log(eps) terms = -27.63 for the two saturated
    # entries, log(.5) halves for the middle
    expect = -(np.log(1e-12) + np.log(1e-12) + np.log(0.5)) / 3.0
    np.testing.assert_allclose(float(l), expect, rtol=1e-5)

    # out-of-range p (the fused-codegen overshoot, hazard (b)): finite
    p_bad = jnp.array([-1e-7, 1.0 + 1e-7], jnp.float32)
    t_bad = jnp.array([1.0, 0.0], jnp.float32)
    assert np.isfinite(float(bce_loss(p_bad, t_bad)))

    # gradient THROUGH a jitted sigmoid chain incl. a saturating z=17
    # (the exact minimal-repro entry): finite, and exactly 0 where the
    # sigmoid saturates (maximum selects the constant branch)
    logits = jnp.array([-40.0, 40.0, 0.0, 17.0], jnp.float32)
    t4 = jnp.array([1.0, 0.0, 0.5, 1.0], jnp.float32)
    val, g = jax.jit(jax.value_and_grad(
        lambda z: bce_loss(jax.nn.sigmoid(z), t4)
    ))(logits)
    assert np.isfinite(float(val)), float(val)
    assert np.all(np.isfinite(np.asarray(g))), g
    np.testing.assert_allclose(float(g[1]), 0.0, atol=1e-30)
