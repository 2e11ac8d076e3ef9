"""Data-parallel training tests on the 8-device virtual CPU mesh —
the rebuild's replacement for the reference's DataParallelTable path
(`multigpu.lua`, SURVEY §2.6)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgtpu.models import get_net
from mgtpu.parallel import make_mesh, replicate, shard_batch
from mgtpu.train.optim import sgd_init, sgd_update
from mgtpu.train.step import make_eval_step, make_train_step


def _setup(iter_size=1):
    opt = types.SimpleNamespace(dataset="cifar100-whitened", nEpochs=200, nLayer=1)
    net = get_net("cifar/nmg")
    model = net.create_model(opt)
    params, stats = jax.jit(model.init)(jax.random.PRNGKey(0))
    loss_fn = net.create_loss(opt)
    step = make_train_step(model, loss_fn, net, iter_size=iter_size)
    return net, model, params, stats, loss_fn, step


def test_sgd_matches_reference_semantics():
    p = {"w": jnp.array([1.0, 2.0])}
    g = {"w": jnp.array([0.5, 0.5])}
    st = sgd_init(p)
    lr, wd, mu = 0.1, 0.01, 0.9
    p1, st1 = sgd_update(p, g, st, lr, wd, mu)
    # g' = g + wd*p ; m = g' ; p -= lr*m
    exp_m = np.array([0.5 + 0.01 * 1.0, 0.5 + 0.01 * 2.0])
    np.testing.assert_allclose(np.asarray(st1["m"]["w"]), exp_m, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p1["w"]), np.array([1.0, 2.0]) - 0.1 * exp_m, rtol=1e-6)
    # second step accumulates momentum
    p2, st2 = sgd_update(p1, g, st1, lr, wd, mu)
    exp_m2 = mu * exp_m + (np.asarray(g["w"]) + wd * np.asarray(p1["w"]))
    np.testing.assert_allclose(np.asarray(st2["m"]["w"]), exp_m2, rtol=1e-6)


def test_sgd_scale_invariant_norm_decay_envelope():
    """With zero gradient (memorized training set), coupled L2 +
    momentum shrink each weight by the lr*wd/(1-mu) envelope per step
    at equilibrium — the quantitative basis of the LR-0.1 spike
    root-cause analysis (PARITY 'constant-LR instability'): a BN-preceded weight's effective LR grows as
    lr/||w||^2 while ||w|| decays along exactly this envelope."""
    lr, wd, mu = 0.1, 5e-4, 0.9
    p = {"w": jnp.array([100.0])}
    st = sgd_init(p)
    g = {"w": jnp.zeros(1)}
    norms = [float(p["w"][0])]
    for _ in range(600):
        p, st = sgd_update(p, g, st, lr, wd, mu)
        norms.append(float(p["w"][0]))
    # after the momentum transient, the per-step decay factor converges
    # to 1 - lr*wd/(1-mu) = 1 - 5e-4
    tail = np.array(norms[-100:])
    ratios = tail[1:] / tail[:-1]
    np.testing.assert_allclose(ratios, 1.0 - lr * wd / (1.0 - mu), rtol=3e-5)


def test_sgd_bucketed_matches_per_leaf():
    """The multi-tensor (bucketed) update path must be bit-identical to
    the per-leaf formulation for a mixed tree: many small leaves (below
    the bucket threshold), one big leaf (above it), and one leaf of a
    different dtype (excluded from the bucket)."""
    key = jax.random.PRNGKey(7)
    ks = jax.random.split(key, 8)
    p = {
        "bn": {f"g{i}": jax.random.normal(ks[i], (64,)) for i in range(4)},
        "conv": jax.random.normal(ks[4], (3, 3, 64, 64)),  # 36864 > 2^13
        "half": jax.random.normal(ks[5], (16,)).astype(jnp.bfloat16),
    }
    g = jax.tree.map(lambda x: jnp.full_like(x, 0.25), p)
    st = sgd_init(p)
    lr, wd, mu = 0.1, 1e-4, 0.9
    pa, sta = p, st
    pb, stb = p, st
    for _ in range(3):
        pa, sta = jax.jit(
            lambda P, G, S: sgd_update(P, G, S, lr, wd, mu, bucket=True)
        )(pa, g, sta)
        pb, stb = jax.jit(
            lambda P, G, S: sgd_update(P, G, S, lr, wd, mu, bucket=False)
        )(pb, g, stb)
    for a, b in zip(jax.tree.leaves((pa, sta)), jax.tree.leaves((pb, stb))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow  # compile-heavy; fast tier keeps test_dp_matches_single_device + grad-accum
def test_train_step_runs_and_learns():
    net, model, params, stats, loss_fn, step = _setup()
    jstep = jax.jit(step)
    opt_state = sgd_init(params)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 32, 32, 3))
    y = jnp.arange(8, dtype=jnp.int32) % 100
    batch = {"x": x, "y": y}
    losses = []
    for i in range(5):
        params, stats, opt_state, m = jstep(
            params, stats, opt_state, batch, 0.05, 5e-4, jax.random.PRNGKey(i)
        )
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # overfits a fixed batch


def test_log_grad_norm_metrics():
    """-logGradNorm adds gradnorm/pnorm/maxupd diagnostics whose values
    must match an independent host-side recomputation: gradnorm =
    global L2 of the raw grads, pnorm = global L2 of the UPDATED
    params, maxupd = max |param change| of the step. (The spike-chasing
    instrumentation — VERDICT r4 next #3.)"""
    opt = types.SimpleNamespace(dataset="cifar100-whitened", nEpochs=200, nLayer=1)
    net = get_net("cifar/nmg")
    model = net.create_model(opt)
    params, stats = jax.jit(model.init)(jax.random.PRNGKey(0))
    loss_fn = net.create_loss(opt)
    step = jax.jit(make_train_step(model, loss_fn, net, log_grad_norm=True))
    plain = jax.jit(make_train_step(model, loss_fn, net))
    opt_state = sgd_init(params)
    batch = {
        "x": jax.random.normal(jax.random.PRNGKey(1), (8, 32, 32, 3)),
        "y": jnp.arange(8, dtype=jnp.int32) % 100,
    }
    lr, wd = 0.05, 5e-4
    p2, s2, o2, m = step(params, stats, opt_state, batch, lr, wd,
                         jax.random.PRNGKey(0))
    for k in ("gradnorm", "pnorm", "maxupd"):
        assert k in m and np.isfinite(float(m[k])), k
    # identical update values as the uninstrumented step
    p2p, _, _, mp = plain(params, stats, opt_state, batch, lr, wd,
                          jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m["loss"]), float(mp["loss"]), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(p2p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # host-side recomputation of all three diagnostics
    pnorm = np.sqrt(sum(float(np.sum(np.square(np.asarray(l, np.float64))))
                        for l in jax.tree.leaves(p2)))
    np.testing.assert_allclose(float(m["pnorm"]), pnorm, rtol=1e-4)
    maxupd = max(float(np.max(np.abs(np.asarray(a, np.float64)
                                     - np.asarray(b, np.float64))))
                 for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(params)))
    np.testing.assert_allclose(float(m["maxupd"]), maxupd, rtol=1e-4)
    grads = jax.jit(jax.grad(
        lambda p: loss_fn(model.apply(p, stats, batch["x"], train=True,
                                      rng=jax.random.PRNGKey(0))[0], batch["y"])
    ))(params)
    gnorm = np.sqrt(sum(float(np.sum(np.square(np.asarray(l, np.float64))))
                        for l in jax.tree.leaves(grads)))
    np.testing.assert_allclose(float(m["gradnorm"]), gnorm, rtol=1e-4)


@pytest.mark.slow  # compile-heavy; fast tier keeps test_dp_matches_single_device + grad-accum
def test_train_step_data_parallel_mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(n_data=8)
    net, model, params, stats, loss_fn, step = _setup()
    params = replicate(mesh, params)
    stats = replicate(mesh, stats)
    opt_state = replicate(mesh, sgd_init(params))
    batch = shard_batch(
        mesh,
        {
            "x": jax.random.normal(jax.random.PRNGKey(1), (16, 32, 32, 3)),
            "y": jnp.arange(16, dtype=jnp.int32) % 100,
        },
    )
    jstep = jax.jit(step)
    with jax.set_mesh(mesh):
        params2, stats2, opt_state2, m = jstep(
            params, stats, opt_state, batch, 0.1, 5e-4, jax.random.PRNGKey(0)
        )
    assert np.isfinite(float(m["loss"]))
    # params remain replicated after the update
    leaf = jax.tree.leaves(params2)[0]
    assert leaf.sharding.is_fully_replicated


def test_dp_matches_single_device():
    # the same batch must produce the same update whether sharded or not
    net, model, params, stats, loss_fn, step = _setup()
    jstep = jax.jit(step)
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 32, 32, 3))
    y = jnp.arange(16, dtype=jnp.int32) % 100
    opt_state = sgd_init(params)
    p1, _, _, m1 = jstep(params, stats, opt_state, {"x": x, "y": y}, 0.1, 5e-4, jax.random.PRNGKey(0))

    mesh = make_mesh(n_data=8)
    pr = replicate(mesh, params)
    sr = replicate(mesh, stats)
    orp = replicate(mesh, opt_state)
    batch = shard_batch(mesh, {"x": x, "y": y})
    p2, _, _, m2 = jstep(pr, sr, orp, batch, 0.1, 5e-4, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    a = np.asarray(jax.tree.leaves(p1)[0])
    b = np.asarray(jax.tree.leaves(p2)[0])
    # sharded vs. unsharded execution picks different XLA conv/reduce
    # schedules, so float32 accumulation order differs; one lr=0.1 SGD
    # step amplifies that to ~1e-5 absolute on these 1e-3-scale params
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_shard_batch_spatial_spec_layouts():
    """Height = third-from-last of the trailing (H,W,C): plain, iter-
    size, and ten-crop batches all shard their true H over 'model';
    labels stay batch-sharded only."""
    def spec(arr, n):  # normalized to rank n (trailing Nones explicit)
        s = tuple(arr.sharding.spec)
        return s + (None,) * (n - len(s))

    mesh = make_mesh(n_data=4, n_model=2)
    plain = shard_batch(mesh, {"x": jnp.ones((8, 32, 32, 3)),
                               "y": jnp.ones((8,), jnp.int32)}, spatial=True)
    assert spec(plain["x"], 4) == ("data", "model", None, None)
    assert spec(plain["y"], 1) == ("data",)
    it = shard_batch(mesh, {"x": jnp.ones((2, 8, 32, 32, 3)),
                            "y": jnp.ones((2, 8), jnp.int32)},
                     batch_axis=1, spatial=True)
    assert spec(it["x"], 5) == (None, "data", "model", None, None)
    ten = shard_batch(mesh, {"x": jnp.ones((8, 10, 32, 32, 3)),
                             "y": jnp.ones((8,), jnp.int32)}, spatial=True)
    # crop axis (size 10) must NOT be sharded; H is
    assert spec(ten["x"], 5) == ("data", None, "model", None, None)


def test_constrain_spatial_spec_logic():
    """Fine scales (>=8 rows/shard, aligned halos) get H sharded over
    'model'; coarse scales are replicated over 'model'; no active mesh
    means identity."""
    from mgtpu.parallel.mesh import constrain_spatial

    x32 = jnp.ones((2, 32, 32, 8))
    assert constrain_spatial(x32) is x32  # no mesh -> untouched

    mesh = make_mesh(n_data=4, n_model=2)
    with jax.set_mesh(mesh):
        f = jax.jit(lambda a, b: (constrain_spatial(a), constrain_spatial(b)))
        y32, y2 = f(x32, jnp.ones((2, 2, 2, 8)))
    spec32 = y32.sharding.spec
    assert spec32[1] == "model", spec32  # 32 rows / 2 shards = 16 >= 8
    spec2 = tuple(y2.sharding.spec)  # trailing Nones are trimmed
    assert len(spec2) < 2 or spec2[1] is None, spec2  # 2-row: replicated


@pytest.mark.slow  # extra GSPMD compile; dryrun_multichip also covers DPxSP
def test_spatial_matches_single_device():
    """DP x SP: batch over 'data' AND input height over 'model'. GSPMD
    inserts the conv/pool halo exchanges; the update must match the
    unsharded step (same tolerance rationale as the DP test above)."""
    net, model, params, stats, loss_fn, step = _setup()
    jstep = jax.jit(step)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 32, 32, 3))
    y = jnp.arange(8, dtype=jnp.int32) % 100
    opt_state = sgd_init(params)
    p1, _, _, m1 = jstep(params, stats, opt_state, {"x": x, "y": y}, 0.1, 5e-4, jax.random.PRNGKey(0))

    mesh = make_mesh(n_data=4, n_model=2)
    pr = replicate(mesh, params)
    sr = replicate(mesh, stats)
    orp = replicate(mesh, opt_state)
    batch = shard_batch(mesh, {"x": x, "y": y}, spatial=True)
    assert not batch["x"].sharding.is_fully_replicated
    with jax.set_mesh(mesh):
        p2, _, _, m2 = jstep(pr, sr, orp, batch, 0.1, 5e-4, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    assert jax.tree.leaves(p2)[0].sharding.is_fully_replicated
    a = np.asarray(jax.tree.leaves(p1)[0])
    b = np.asarray(jax.tree.leaves(p2)[0])
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_tp_sharding_spec_logic():
    """Channel (tensor) sharding picks the trailing dim only when it
    divides and keeps >=8 channels/shard; everything else replicates."""
    from mgtpu.parallel import tp_sharding

    mesh = make_mesh(n_data=4, n_model=2, model_axis="tensor")
    conv = jnp.ones((3, 3, 16, 32))  # HWIO, O=32 -> sharded
    assert tuple(tp_sharding(mesh, conv).spec) == (None, None, None, "tensor")
    bn = jnp.ones((32,))  # C=32 -> sharded
    assert tuple(tp_sharding(mesh, bn).spec) == ("tensor",)
    small = jnp.ones((3, 3, 3, 8))  # 8/2 = 4 < 8 channels/shard -> replicated
    assert tuple(tp_sharding(mesh, small).spec) == ()
    odd = jnp.ones((15,))  # 15 % 2 != 0 -> replicated
    assert tuple(tp_sharding(mesh, odd).spec) == ()
    scalar = jnp.float32(1.0)  # rank-0 -> replicated
    assert tuple(tp_sharding(mesh, scalar).spec) == ()


@pytest.mark.slow  # extra GSPMD compile; dryrun_multichip also covers DPxTP
def test_tensor_parallel_matches_single_device():
    """DP x TP: batch over 'data', conv output channels + BN + momentum
    over 'tensor' (1/N param and optimizer memory per device). GSPMD
    propagates the channel layout through fwd/bwd and inserts the
    collectives; the update must match the unsharded step."""
    from mgtpu.parallel import shard_params_tp

    net, model, params, stats, loss_fn, step = _setup()
    jstep = jax.jit(step)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 32, 32, 3))
    y = jnp.arange(8, dtype=jnp.int32) % 100
    opt_state = sgd_init(params)
    p1, _, _, m1 = jstep(params, stats, opt_state, {"x": x, "y": y}, 0.1, 5e-4, jax.random.PRNGKey(0))

    mesh = make_mesh(n_data=4, n_model=2, model_axis="tensor")
    pr = shard_params_tp(mesh, params)
    sr = shard_params_tp(mesh, stats)
    orp = shard_params_tp(mesh, opt_state)
    # the zoo's channel widths are multiples of 16, so the big leaves
    # must actually shard (the memory-scaling claim, not just a no-op)
    assert any(
        not l.sharding.is_fully_replicated for l in jax.tree.leaves(pr)
    )
    batch = shard_batch(mesh, {"x": x, "y": y})
    with jax.set_mesh(mesh):
        p2, _, _, m2 = jstep(pr, sr, orp, batch, 0.1, 5e-4, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
        )


def test_grad_accumulation_iter_size():
    net, model, params, stats, loss_fn, _ = _setup()
    step1 = jax.jit(make_train_step(model, loss_fn, net, iter_size=1))
    step2 = jax.jit(make_train_step(model, loss_fn, net, iter_size=2))
    opt_state = sgd_init(params)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, 32, 3))
    y = jnp.arange(4, dtype=jnp.int32) % 100
    # two IDENTICAL micro-batches: the mean accumulated gradient equals
    # the single-micro-batch gradient exactly (train-mode BN uses batch
    # stats, so the second micro-batch sees the same forward)
    pa, _, _, ma = step1(params, stats, opt_state, {"x": x, "y": y}, 0.1, 0.0, jax.random.PRNGKey(0))
    xb = jnp.stack([x, x])
    yb = jnp.stack([y, y])
    pb, _, _, mb = step2(params, stats, opt_state, {"x": xb, "y": yb}, 0.1, 0.0, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_eval_step():
    net, model, params, stats, loss_fn, _ = _setup()
    estep = jax.jit(make_eval_step(model, loss_fn, net))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, 32, 3))
    y = jnp.arange(4, dtype=jnp.int32)
    m, out = estep(params, stats, {"x": x, "y": y})
    assert out.shape == (4, 100)
    assert 0.0 <= float(m["top1"]) <= 1.0


@pytest.mark.slow  # compile-heavy; fast tier keeps test_dp_matches_single_device + grad-accum
def test_tencrop_eval_step():
    """10-crop eval averages crop probabilities: feeding 10 IDENTICAL
    crops must reproduce the single-crop metrics exactly, and mixed
    crops must equal the manual prob-mean."""
    net, model, params, stats, loss_fn, _ = _setup()
    from mgtpu.train.step import make_tencrop_eval_step

    estep = jax.jit(make_eval_step(model, loss_fn, net))
    tstep = jax.jit(make_tencrop_eval_step(model, loss_fn, net))
    x = jax.random.normal(jax.random.PRNGKey(2), (3, 32, 32, 3))
    y = jnp.arange(3, dtype=jnp.int32)
    m1, out1 = estep(params, stats, {"x": x, "y": y})
    xr = jnp.broadcast_to(x[:, None], (3, 10, 32, 32, 3))
    m10, out10 = tstep(params, stats, {"x": xr, "y": y})
    np.testing.assert_allclose(float(m1["top1"]), float(m10["top1"]))
    np.testing.assert_allclose(np.asarray(out10), np.asarray(out1),
                               rtol=1e-4, atol=1e-5)
    # genuinely different crops -> mean of probs
    crops = jax.random.normal(jax.random.PRNGKey(3), (2, 10, 32, 32, 3))
    _, outm = tstep(params, stats, {"x": crops, "y": y[:2]})
    flat, _ = jax.jit(lambda p, s, x: model.apply(p, s, x, train=False))(
        params, stats, crops.reshape(20, 32, 32, 3))
    ref = jax.nn.logsumexp(flat.reshape(2, 10, -1), axis=1) - jnp.log(10.0)
    np.testing.assert_allclose(np.asarray(outm), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.slow  # compile-heavy; fast tier keeps test_dp_matches_single_device + grad-accum
def test_remat_train_step_matches():
    """-remat changes memory behavior, not numerics: one update with
    jax.checkpoint must equal the plain step bit-for-bit."""
    net, model, params, stats, loss_fn, _ = _setup()
    sa = jax.jit(make_train_step(model, loss_fn, net))
    sb = jax.jit(make_train_step(model, loss_fn, net, remat=True))
    opt_state = sgd_init(params)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, 32, 3))
    y = jnp.arange(4, dtype=jnp.int32)
    pa, _, _, ma = sa(params, stats, opt_state, {"x": x, "y": y}, 0.1, 5e-4, jax.random.PRNGKey(0))
    pb, _, _, mb = sb(params, stats, opt_state, {"x": x, "y": y}, 0.1, 5e-4, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_zero1_spec_logic():
    """ZeRO-1 momentum sharding picks the trailing dim when it divides
    the data-axis size; no minimum-shard rule (momentum never feeds a
    conv, only elementwise update math + one all-gather)."""
    from mgtpu.parallel import zero1_spec

    conv = jnp.ones((3, 3, 16, 32))  # HWIO, O=32 -> sharded
    assert tuple(zero1_spec(conv, 8)) == (None, None, None, "data")
    bn = jnp.ones((16,))  # 16/8 = 2 per shard: still sharded
    assert tuple(zero1_spec(bn, 8)) == ("data",)
    odd = jnp.ones((15,))  # 15 % 8 != 0 -> replicated
    assert tuple(zero1_spec(odd, 8)) == ()
    scalar = jnp.float32(1.0)  # rank-0 -> replicated
    assert tuple(zero1_spec(scalar, 8)) == ()
    assert tuple(zero1_spec(conv, 1)) == ()  # single device -> replicated


def test_zero1_matches_single_device():
    """DP + ZeRO-1 (-zero1): SGD momentum sharded over 'data' (1/N
    optimizer memory per chip), params replicated. The update must
    match the unsharded step, the momentum must COME OUT still sharded
    (the step re-asserts the layout so GSPMD can't propagate it away),
    and the params must come out replicated (so the next step's convs
    don't pay per-use kernel all-gathers)."""
    from mgtpu.parallel import shard_opt_zero1

    net, model, params, stats, loss_fn, step = _setup()
    p1, _, o1, m1 = jax.jit(step)(
        params, stats, sgd_init(params),
        {"x": jax.random.normal(jax.random.PRNGKey(1), (16, 32, 32, 3)),
         "y": jnp.arange(16, dtype=jnp.int32) % 100},
        0.1, 5e-4, jax.random.PRNGKey(0),
    )

    zstep = jax.jit(make_train_step(model, loss_fn, net,
                                    bucket_sgd=False, zero1=True))
    mesh = make_mesh(n_data=8)
    pr = replicate(mesh, params)
    sr = replicate(mesh, stats)
    oz = shard_opt_zero1(mesh, sgd_init(params))
    sharded_in = [l for l in jax.tree.leaves(oz)
                  if not l.sharding.is_fully_replicated]
    assert sharded_in, "no momentum leaf was zero1-sharded at placement"
    big = max(sharded_in, key=lambda a: a.size)
    # the memory contract, measured: each device holds exactly 1/8
    assert big.addressable_shards[0].data.nbytes == big.nbytes // 8
    batch = shard_batch(
        mesh,
        {"x": jax.random.normal(jax.random.PRNGKey(1), (16, 32, 32, 3)),
         "y": jnp.arange(16, dtype=jnp.int32) % 100},
    )
    with jax.set_mesh(mesh):
        p2, _, o2, m2 = zstep(pr, sr, oz, batch, 0.1, 5e-4,
                              jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for leaf in jax.tree.leaves(p2):
        assert leaf.sharding.is_fully_replicated
    for a, b in zip(jax.tree.leaves(oz), jax.tree.leaves(o2)):
        assert a.sharding.spec == b.sharding.spec, (a.sharding, b.sharding)
    # same update values as the unsharded step (same tolerance rationale
    # as test_dp_matches_single_device)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
        )
    for a, b in zip(jax.tree.leaves(o1), jax.tree.leaves(o2)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
        )
