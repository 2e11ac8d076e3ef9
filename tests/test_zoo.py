"""Golden-topology tests for the model zoo: every netType builds,
forwards (jitted), and its parameter count is pinned (regression
against accidental channel-arithmetic changes; the block plans mirror
SURVEY §2.4 / the reference model files cited in each module)."""

import types

import jax
import jax.numpy as jnp
import pytest

from mgtpu.models import get_net, list_models
from mgtpu.nn import param_count

CIFAR_OPT = dict(dataset="cifar100-whitened", nEpochs=200, nLayer=1)
MNIST_OPT = dict(dataset="mnist-seg", nEpochs=60, nLayer=1)

# (netType, opt, input shape, expected output shape, pinned param count ~1e4)
CASES = [
    ("cifar/nmg", CIFAR_OPT, (2, 32, 32, 3), (2, 100), 3.36e6),
    ("cifar/pnmg", {**CIFAR_OPT, "isDropout": True}, (2, 32, 32, 3), (2, 100), 8.46e6),
    ("cifar/rnmg", {**CIFAR_OPT, "isDropout": True}, (2, 32, 32, 3), (2, 100), 8.06e6),
    ("cifar/prnmg", {**CIFAR_OPT, "isDropout": True}, (2, 32, 32, 3), (2, 100), 20.60e6),
    ("cifar/resnet", CIFAR_OPT, (2, 32, 32, 3), (2, 100), 9.50e6),
    ("cifar/vgg", CIFAR_OPT, (2, 32, 32, 3), (2, 100), 10.02e6),
    ("mnist-cluttered/unet", MNIST_OPT, (2, 64, 64, 1), (2, 64, 64, 10), 3.79e6),
    ("mnist-cluttered/unmg", MNIST_OPT, (2, 64, 64, 1), (2, 64, 64, 10), 5.90e6),
    ("mnist-cluttered/pnmg.mnist", MNIST_OPT, (2, 64, 64, 1), (2, 64, 64, 10), 0.61e6),
    (
        "mnist-cluttered/prnmg.mnist",
        {**MNIST_OPT, "dataset": "mnist-spt"},
        (2, 64, 64, 1),
        (2, 64, 64, 1),
        1.20e6,
    ),
]


@pytest.mark.parametrize("name,o,in_shape,out_shape,n_params", CASES)
def test_model_param_counts(name, o, in_shape, out_shape, n_params):
    """Topology pin WITHOUT compiling: eval_shape the initializer and
    check the parameter count and (abstract) output shape. This is the
    fast-tier regression against channel-arithmetic changes; the
    compiled forward lives in the slow tier below."""
    opt = types.SimpleNamespace(**o)
    net = get_net(name)
    model = net.create_model(opt)
    params, stats = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    assert abs(param_count(params) - n_params) < 0.01e6, param_count(params)

    x = jax.ShapeDtypeStruct(in_shape, jnp.float32)
    out, _ = jax.eval_shape(
        lambda p, s, x: model.apply(p, s, x, train=False), params, stats, x
    )
    assert out.shape == out_shape


# compiling every zoo model takes 10-80s each on a 1-core CPU host, so
# the jitted train-mode forward is slow-tier (VERDICT round 1 item 9);
# the cheap members stay fast so the tier still exercises the code path
_HEAVY_FWD = {"cifar/pnmg", "cifar/rnmg", "cifar/prnmg",
              "mnist-cluttered/unmg", "mnist-cluttered/pnmg.mnist",
              "mnist-cluttered/prnmg.mnist"}


@pytest.mark.parametrize(
    "name,o,in_shape,out_shape,n_params",
    [pytest.param(*c, marks=pytest.mark.slow) if c[0] in _HEAVY_FWD
     else c for c in CASES],
)
def test_model_builds_and_forwards(name, o, in_shape, out_shape, n_params):
    opt = types.SimpleNamespace(**o)
    net = get_net(name)
    model = net.create_model(opt)
    params, stats = jax.jit(model.init)(jax.random.PRNGKey(0))
    assert abs(param_count(params) - n_params) < 0.01e6, param_count(params)

    fwd = jax.jit(lambda p, s, x, k: model.apply(p, s, x, train=True, rng=k))
    out, new_stats = fwd(params, stats, jnp.ones(in_shape), jax.random.PRNGKey(1))
    assert out.shape == out_shape
    loss_fn = net.create_loss(opt)
    if name.startswith("mnist"):
        loss = loss_fn(out, jnp.zeros(out.shape))
    else:
        loss = loss_fn(out, jnp.zeros((in_shape[0],), jnp.int32))
    assert jnp.isfinite(loss)


def test_train_rules():
    opt = types.SimpleNamespace(nEpochs=200)
    r = get_net("cifar/nmg").train_rule(1, opt)
    assert abs(r["lr"] - 0.1) < 1e-9 and r["wd"] == 5e-4
    r = get_net("cifar/nmg").train_rule(200, opt)
    assert abs(r["lr"] - 1e-4) < 1e-9
    r = get_net("cifar/rnmg").train_rule(60, opt)
    assert abs(r["lr"] - 0.02) < 1e-9
    r = get_net("ilsvrc/rnmg").train_rule(31, opt)
    assert abs(r["lr"] - 0.01) < 1e-9


def test_registry_complete():
    # every reference netType has a counterpart (SURVEY §2.4)
    expected = {
        "cifar/nmg", "cifar/pnmg", "cifar/rnmg", "cifar/prnmg",
        "cifar/resnet", "cifar/vgg", "ilsvrc/rnmg", "ilsvrc/prnmgseg",
        "mnist-cluttered/unet", "mnist-cluttered/unmg",
        "mnist-cluttered/pnmg.mnist", "mnist-cluttered/prnmg.mnist",
        "mnist-cluttered/mnist-test", "mnist-cluttered/mnist-saliency",
    }
    assert expected <= set(list_models())


TRAIN_CASES = [
    # models not already train-stepped elsewhere (nmg: convergence/DP
    # tests; rnmg: dryrun + chip_smoke.py)
    ("cifar/pnmg", {**CIFAR_OPT, "isDropout": True}, (4, 32, 32, 3), 100),
    ("cifar/prnmg", {**CIFAR_OPT, "isDropout": True}, (4, 32, 32, 3), 100),
    ("cifar/resnet", CIFAR_OPT, (4, 32, 32, 3), 100),
    ("cifar/vgg", CIFAR_OPT, (4, 32, 32, 3), 100),
    ("mnist-cluttered/unet", MNIST_OPT, (2, 64, 64, 1), None),
    ("mnist-cluttered/unmg", MNIST_OPT, (2, 64, 64, 1), None),
    ("mnist-cluttered/pnmg.mnist", MNIST_OPT, (2, 64, 64, 1), None),
    ("mnist-cluttered/prnmg.mnist", {**MNIST_OPT, "dataset": "mnist-spt"},
     (2, 64, 64, 1), None),
    # prnmgseg's head avg-pools 7x7 on grid 4 (= input/32): needs 224px
    ("ilsvrc/prnmgseg", {"dataset": "ilsvrc", "nEpochs": 90, "depth": 30,
                         "shortcutType": "B"}, (1, 224, 224, 3), 1000),
]


@pytest.mark.slow  # compile-heavy: fwd+bwd for every zoo model
@pytest.mark.parametrize("name,o,in_shape,n_classes", TRAIN_CASES)
def test_model_train_step(name, o, in_shape, n_classes):
    """Every zoo model must take a gradient step (finite loss, params
    change) — forward-only shape tests miss backward/dropout/shortcut
    bugs."""
    from mgtpu.train.optim import sgd_init
    from mgtpu.train.step import make_train_step

    opt = types.SimpleNamespace(**o)
    net = get_net(name)
    model = net.create_model(opt)
    params, stats = jax.jit(model.init)(jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(model, net.create_loss(opt), net))
    x = jax.random.normal(jax.random.PRNGKey(1), in_shape)
    if n_classes is None:  # dense targets (BCE heads)
        out, _ = jax.jit(lambda p, s, x: model.apply(p, s, x, train=False))(
            params, stats, x)
        y = (jax.random.uniform(jax.random.PRNGKey(2), out.shape) > 0.5
             ).astype(jnp.float32)
    else:
        y = (jnp.arange(in_shape[0]) % n_classes).astype(jnp.int32)
    p2, s2, o2, m = step(params, stats, sgd_init(params),
                         {"x": x, "y": y}, 0.05, 5e-4, jax.random.PRNGKey(3))
    import numpy as np

    assert np.isfinite(float(m["loss"]))
    a0 = np.asarray(jax.tree.leaves(params)[0])
    a1 = np.asarray(jax.tree.leaves(p2)[0])
    assert not np.array_equal(a0, a1), "params did not change"
