"""BN-folding exactness (mgtpu/ops/fold.py): the folded eval forward
must reproduce the unfolded one — per layer unit and across the zoo.
The semantics preserved are
`nn.SpatialBatchNormalization` eval mode
(`/root/reference/models/cifar/nmg.lua:23`)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgtpu.nn import ConvBN, UpConvBN
from mgtpu.ops.fold import fold_batchnorm


def _jitter(params, stats, seed=0):
    """Make the BN affine + running stats non-trivial so the fold has
    something real to absorb (fresh init is scale=1/bias=0/mean=0/var=1,
    for which folding is a near no-op)."""
    rng = np.random.default_rng(seed)

    def fp(path, x):
        name = getattr(path[-1], "key", "")
        if name == "scale" and x.ndim == 1:  # BN gamma
            return jnp.asarray(rng.uniform(-1.5, 1.5, x.shape), jnp.float32)
        if name == "bias" and x.ndim == 1:
            return jnp.asarray(rng.normal(0, 0.5, x.shape), jnp.float32)
        return x

    def fs(path, x):
        name = getattr(path[-1], "key", "")
        if name == "mean":
            return jnp.asarray(rng.normal(0, 0.7, x.shape), jnp.float32)
        if name == "var":
            return jnp.asarray(rng.uniform(0.25, 2.0, x.shape), jnp.float32)
        return x

    return (jax.tree_util.tree_map_with_path(fp, params),
            jax.tree_util.tree_map_with_path(fs, stats))


def _assert_fold_exact(model, params, stats, x, atol=2e-5):
    y0, _ = model.apply(params, stats, x, train=False)
    fp, fs = fold_batchnorm(model, params, stats)
    y1, _ = model.apply(fp, fs, x, train=False)
    np.testing.assert_allclose(np.asarray(y0), np.asarray(y1),
                               atol=atol, rtol=1e-5)
    return fp, fs


def test_convbn_fold_exact():
    layer = ConvBN(4, 8, 3, relu=True, eps=1e-3)
    p, s = layer.init(jax.random.PRNGKey(0))
    p, s = _jitter(p, s)
    x = jnp.asarray(np.random.default_rng(1).normal(0, 1, (2, 9, 9, 4)), jnp.float32)
    fp, fs = _assert_fold_exact(layer, p, s, x)
    assert fs["bn"] == {} and fp["bn"] == {}


def test_upconvbn_fold_exact():
    layer = UpConvBN(6, 3)
    p, s = layer.init(jax.random.PRNGKey(0))
    p, s = _jitter(p, s)
    x = jnp.asarray(np.random.default_rng(2).normal(0, 1, (2, 5, 5, 6)), jnp.float32)
    _assert_fold_exact(layer, p, s, x)


def test_fold_idempotent_and_train_raises():
    layer = ConvBN(3, 5, 3, relu=False)
    p, s = layer.init(jax.random.PRNGKey(0))
    p, s = _jitter(p, s)
    fp, fs = fold_batchnorm(layer, p, s)
    fp2, fs2 = fold_batchnorm(layer, fp, fs)  # no double-fold
    for a, b in zip(jax.tree.leaves(fp), jax.tree.leaves(fp2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = jnp.ones((1, 6, 6, 3))
    with pytest.raises(ValueError, match="folded"):
        layer.apply(fp, fs, x, train=True)


def test_resblock_fold_both_shortcut_kinds():
    from mgtpu.models.common import ResBlock

    for cin, cout in ((6, 10), (10, 6)):  # zero-pad widen / 1x1-conv narrow
        blk = ResBlock(cin, cout)
        p, s = blk.init(jax.random.PRNGKey(3))
        p, s = _jitter(p, s, seed=cin)
        x = jnp.asarray(
            np.random.default_rng(4).normal(0, 1, (2, 8, 8, cin)), jnp.float32
        )
        _assert_fold_exact(blk, p, s, x)


CIFAR_OPT = dict(dataset="cifar100-whitened", nEpochs=200, nLayer=1)
MNIST_OPT = dict(dataset="mnist-seg", nEpochs=60, nLayer=1)

# eager forwards (no jit) — compile-free, so the whole-zoo sweep stays
# affordable; the heavy members still go slow-tier for the 1-core box
ZOO = [
    ("cifar/nmg", CIFAR_OPT, (1, 32, 32, 3), False),
    ("cifar/vgg", CIFAR_OPT, (1, 32, 32, 3), False),
    ("cifar/resnet", CIFAR_OPT, (1, 32, 32, 3), False),
    ("mnist-cluttered/unet", MNIST_OPT, (1, 64, 64, 1), False),
    ("cifar/pnmg", CIFAR_OPT, (1, 32, 32, 3), True),
    ("cifar/rnmg", CIFAR_OPT, (1, 32, 32, 3), True),
    ("cifar/prnmg", CIFAR_OPT, (1, 32, 32, 3), True),
    ("mnist-cluttered/unmg", MNIST_OPT, (1, 64, 64, 1), True),
    ("mnist-cluttered/pnmg.mnist", MNIST_OPT, (1, 64, 64, 1), True),
    ("mnist-cluttered/prnmg.mnist", {**MNIST_OPT, "dataset": "mnist-spt"},
     (1, 64, 64, 1), True),
    # the flagship bench/export family: bench.py's headline serving
    # graph times exactly this fold, so its exactness must be pinned
    # too (depth 18 keeps the
    # eager 224px forward affordable; the fold walker is depth-agnostic)
    ("ilsvrc/rnmg", dict(depth=18), (1, 224, 224, 3), True),
    ("ilsvrc/prnmgseg", dict(depth=30, shortcutType="C"), (1, 224, 224, 3), True),
]


@pytest.mark.parametrize(
    "name,o,in_shape",
    [pytest.param(n, o, sh, marks=pytest.mark.slow) if heavy
     else (n, o, sh) for n, o, sh, heavy in ZOO],
)
def test_zoo_fold_exact(name, o, in_shape):
    from mgtpu.models import get_net

    opt = types.SimpleNamespace(**o)
    model = get_net(name).create_model(opt)
    p, s = model.init(jax.random.PRNGKey(7))
    p, s = _jitter(p, s, seed=11)
    x = jnp.asarray(
        np.random.default_rng(8).normal(0, 1, in_shape), jnp.float32
    )
    # atol: the fold is algebraically exact but reassociates f32
    # arithmetic (W*a folded into the kernel vs BN applied post-conv),
    # so deep nets accumulate a few-ULP drift; measured worst case
    # 1.3e-4 on one prnmg.mnist output element
    fp, fs = _assert_fold_exact(model, p, s, x, atol=5e-4)
    # every BN in these zoo nets sits behind a conv — the fold must
    # have eliminated ALL of them (no 'var' leaf left anywhere)
    names = {getattr(q[-1], "key", "")
             for q, _ in jax.tree_util.tree_flatten_with_path(fs)[0]}
    assert "var" not in names, names
