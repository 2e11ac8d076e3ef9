"""Standard train/test/eval pipeline — rebuild of
`pipelines/standard/{pipeline,train,test,eval}.lua`.

Epoch driver (`pipeline.lua:1-10`): for EPOCH = epochNumber..nEpochs run
train(), eval() every nEpochsEval, test() every nEpochsTest, checkpoint
every nEpochsSave. The per-iteration stdout format keeps the reference's
`Run:… lr:… Data:…` shape (`train.lua:184-199`)."""

from __future__ import annotations

import os
import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from mgtpu.parallel.mesh import fetch_global, gather_tree, is_primary
from mgtpu.utils.logging import EpochLogger, fmt_metrics, now


def host_cast_inputs(batch, dtype):
    """Cast the INPUT ('x') leaves of a batch dict to the compute dtype
    on the host, before device transfer. Under `-dtype bfloat16` this
    halves H2D bytes — the first conv casts its input to the compute
    dtype anyway (`mgtpu/nn.py:Conv.apply cast_to`), so the device-side
    values are unchanged up to pre-conv pooling now rounding in bf16
    (models whose stem avgpools the raw image, e.g. MgConvInput).
    Labels stay float32: losses and metrics keep full precision.
    Opt out with `-hostCast 0`."""
    if dtype is None or not isinstance(batch, dict) or "x" not in batch:
        return batch
    tgt = np.dtype(dtype)

    def cast(a):
        a = np.asarray(a)
        return a.astype(tgt) if a.dtype == np.float32 else a

    return {**batch, "x": jax.tree.map(cast, batch["x"])}


class Session:
    """Replaces the reference's process globals (OPT/MODEL/NETOBJ/
    DONKEYS/trainLoader/... — `main.lua:21-27`) with one object."""

    def __init__(self, opt):
        from mgtpu.data import get_loaders
        from mgtpu.data.prefetch import DonkeyPool
        from mgtpu.models import get_net
        from mgtpu.parallel import (
            make_mesh,
            replicate,
            shard_batch,
            shard_params_tp,
        )
        from mgtpu.train.optim import sgd_init
        from mgtpu.train.step import make_eval_step, make_train_step
        from mgtpu.utils.checkpoint import load_checkpoint, model_meta

        self.opt = opt
        self.net = get_net(opt.netType)
        self.model = self.net.create_model(opt)
        self.loss_fn = self.net.create_loss(opt)

        n_spatial = max(getattr(opt, "spatial", 1), 1)
        n_tensor = max(getattr(opt, "tensor", 1), 1)
        if n_spatial > 1 and n_tensor > 1:
            raise SystemExit(
                "-spatial and -tensor both shard the second mesh axis; "
                "use one or the other"
            )
        n_model = n_spatial * n_tensor
        if jax.device_count() % n_model or jax.device_count() < n_model:
            raise SystemExit(
                f"-spatial/-tensor {n_model} needs a device count divisible "
                f"by it (have {jax.device_count()})"
            )
        avail = jax.device_count() // n_model
        if opt.nGPU > avail:
            raise SystemExit(
                f"-nGPU {opt.nGPU} asks for more devices than are present: "
                f"{jax.device_count()} devices"
                + (f" / {n_model} per model group = {avail}" if n_model > 1 else "")
            )
        requested = opt.nGPU if opt.nGPU > 0 else avail
        n_data = requested
        # the reference's DataParallelTable scattered uneven chunks
        # (`scripts/cifar/rnmg.sh` runs batch 64 on 3 GPUs); XLA
        # shardings need the batch to divide, so clamp to the largest
        # divisor of batchSize
        while opt.batchSize % n_data:
            n_data -= 1
        if n_data != requested:
            print(f"==> nGPU clamped to {n_data} (batchSize {opt.batchSize} "
                  f"must divide across the data mesh)")
        self.mesh = make_mesh(
            n_data=n_data, n_model=n_model,
            model_axis="tensor" if n_tensor > 1 else "model",
        )
        self._spatial = n_spatial > 1
        self._tensor = n_tensor > 1
        self._zero1 = bool(getattr(opt, "zero1", False))
        if self._zero1 and n_data == 1:
            print("==> -zero1 has no effect: the data mesh axis is size 1 "
                  "(nGPU 1, or batchSize clamped it) — momentum stays "
                  "replicated and optimizer memory is NOT sharded")
        if self._zero1 and self._tensor:
            raise SystemExit(
                "-zero1 and -tensor are mutually exclusive: tensor "
                "parallelism already shards the momentum 1/N over the "
                "'tensor' axis"
            )

        key = jax.random.PRNGKey(opt.manualSeed)
        start = self.net.initial_state(opt, self.model) if hasattr(self.net, "initial_state") else None
        if start is not None:
            params, stats, opt_state = start
        elif opt.retrain != "none":
            ckpt = load_checkpoint(opt.retrain, allow_pickle=getattr(opt, "allowPickleCkpt", False))
            params, stats = ckpt["params"], ckpt["stats"]
            opt_state = ckpt["opt_state"] or sgd_init(params)
            print(f"=> resumed from {opt.retrain} (epoch {ckpt['epoch']})")
        else:
            params, stats = jax.jit(self.model.init)(key)
            opt_state = sgd_init(params)
        self.loaders = get_loaders(opt)
        if self._tensor:
            place = lambda tree: shard_params_tp(self.mesh, tree)
        else:
            place = lambda tree: replicate(self.mesh, tree)
        self.params = place(params)
        self.stats = place(stats)
        if self._zero1:
            from mgtpu.parallel import shard_opt_zero1

            self.opt_state = shard_opt_zero1(self.mesh, opt_state)
        else:
            self.opt_state = place(opt_state)
        self.meta = model_meta(opt)

        self.pool = DonkeyPool(
            opt.nDonkeys,
            mode=getattr(opt, "donkeyMode", "thread"),
            opt=opt,
            loaders=self.loaders,
        )
        self.epoch = opt.epochNumber

        # donate params/stats/opt_state: each call consumes the previous
        # call's outputs, so XLA can update in place (halves peak param
        # HBM and removes defensive copies)
        self.train_step = jax.jit(
            make_train_step(self.model, self.loss_fn, self.net,
                            iter_size=opt.iterSize, momentum=opt.momentum,
                            remat=getattr(opt, "remat", False),
                            # bucketing concatenates momentum leaves,
                            # which would all-gather 'tensor'- or
                            # 'data'-sharded ones inside the update
                            bucket_sgd=not (self._tensor or self._zero1),
                            zero1=self._zero1,
                            log_grad_norm=getattr(opt, "logGradNorm", False)),
            donate_argnums=(0, 1, 2),
        )
        from mgtpu.train.step import make_tencrop_eval_step

        mk_eval = (
            make_tencrop_eval_step if getattr(opt, "tenCrop", False) else make_eval_step
        )
        self.test_step = jax.jit(mk_eval(self.model, self.loss_fn, self.net, "test"))
        self.eval_step = jax.jit(mk_eval(self.model, self.loss_fn, self.net, "eval"))
        # padded-tail metric recomputation, jitted ONCE per session (a
        # per-epoch lambda would recompile every test() call)
        self.test_metrics_fn = jax.jit(
            lambda out, y: self.net.test_metrics(out, y, self.loss_fn(out, y))
        )
        self.eval_metrics_fn = jax.jit(
            lambda out, y: self.net.eval_metrics(out, y, self.loss_fn(out, y))
        )
        cast_dtype = (
            getattr(opt, "compute_dtype", None)
            if getattr(opt, "hostCast", 1) else None
        )
        self._shard = lambda tree, axis=0: shard_batch(
            self.mesh, host_cast_inputs(tree, cast_dtype), axis,
            spatial=self._spatial,
        )
        self._loggers: Dict[str, EpochLogger] = {}

    def logger(self, name: str) -> EpochLogger:
        if name not in self._loggers:
            self._loggers[name] = EpochLogger(os.path.join(self.opt.save, f"{name}.log"))
        return self._loggers[name]

    def lr_wd(self):
        opt = self.opt
        if opt.LR != 0.0:  # manual override (`train.lua:25-31`)
            return {"lr": opt.LR, "wd": opt.weightDecay}
        return self.net.train_rule(self.epoch, opt)


def _acc_update(acc: Dict[str, float], metrics: Dict[str, float], n: int):
    for k, v in metrics.items():
        s, c = acc.get(k, (0.0, 0))
        acc[k] = (s + float(v) * n, c + n)


def _acc_mean(acc) -> Dict[str, float]:
    return {k: s / max(c, 1) for k, (s, c) in acc.items()}


def train(sess: Session):
    opt = sess.opt
    params = sess.lr_wd()
    lr, wd = params["lr"], params["wd"]
    print("==> doing epoch on training data:")
    print(f"==> online epoch # {sess.epoch}")
    if getattr(opt, "resetMomentum", False):
        # the reference rebuilt optimState each epoch, dropping momentum
        # (`pipelines/standard/train.lua:48-55`) — opt-in reproduction
        from mgtpu.train.optim import reset_momentum

        sess.opt_state = reset_momentum(sess.opt_state)

    seed0 = opt.manualSeed * 1_000_003 + sess.epoch * opt.epochSize * opt.iterSize

    def specs():
        for it in range(opt.epochSize):
            yield ("gen", "train", opt.batchSize, sess.epoch,
                   seed0 + it * opt.iterSize, opt.iterSize)

    # tracing subsystem (SURVEY §5): -profile DIR captures iterations
    # 2..9 (1 is compile) of the FIRST epoch only with jax.profiler
    prof_dir = getattr(opt, "profile", "") if sess.epoch == opt.epochNumber else ""
    prof_live = False

    acc: Dict[str, tuple] = {}
    t_epoch = time.time()
    t_data = time.time()
    rng = jax.random.PRNGKey(seed0)
    n = opt.batchSize * opt.iterSize

    # Metrics are synced ONE iteration late: fetching a metric value
    # blocks the host on the device step, which would serialize dispatch
    # with compute. Holding iteration i's (device-resident) metrics
    # while dispatching i+1 keeps the device busy back-to-back; the
    # per-iteration line is printed one step later with identical
    # content. (The reference's trainBatch printed synchronously but its
    # donkey queue gave it the same overlap, `train.lua:184-199`.)
    pending = None  # (it, device metrics, dispatch timestamp, data_t)

    def flush(p, overlap=0.0):
        """Run: = this step's dispatch-to-done wall. If fetching the
        metrics actually blocked, the step was still running — the host
        work since dispatch (next batch fetch) overlapped it and added
        nothing, so the full elapsed time IS the step wall. If the fetch
        returned immediately, the step finished during that host work,
        so the overlap is subtracted rather than double-counted against
        the next line's Data:."""
        p_it, p_metrics, p_t0, p_data_t = p
        t_block = time.time()
        vals = jax.tree.map(float, p_metrics)  # blocks until step done
        t_done = time.time()
        stepped = (t_done - t_block) > 1e-3  # we genuinely waited
        run_t = max(t_done - p_t0 - (0.0 if stepped else overlap), 0.0)
        _acc_update(acc, vals, n)
        print(
            f"{now()} Epoch: [{sess.epoch}][{p_it + 1}/{opt.epochSize}]\t"
            f"Run:{run_t:.3f}s lr:{lr:.3e} Data:{p_data_t:.3f}s "
            + fmt_metrics(vals)
        )

    with jax.set_mesh(sess.mesh):
        for it, batch in enumerate(sess.pool.imap_specs(specs())):
            data_t = time.time() - t_data
            if prof_dir and it == 1 and not prof_live:
                jax.profiler.start_trace(prof_dir)
                prof_live = True
            batch = sess._shard(batch, 1 if opt.iterSize > 1 else 0)
            rng, sub = jax.random.split(rng)
            t_run = time.time()
            sess.params, sess.stats, sess.opt_state, metrics = sess.train_step(
                sess.params, sess.stats, sess.opt_state, batch, lr, wd, sub
            )
            if pending is not None:
                flush(pending, overlap=data_t)
            pending = (it, metrics, t_run, data_t)
            if prof_live and it >= 8:
                # flush (= block on) the just-dispatched step first so
                # the capture contains it completely; stop_trace while
                # it is mid-flight would truncate the final step
                flush(pending)
                pending = None
                jax.profiler.stop_trace()
                prof_live = False
                prof_dir = ""
                print(f"profiler trace -> {opt.profile}")
            t_data = time.time()
        if pending is not None:
            flush(pending)
        if prof_live:  # epochSize < 9: close the trace at epoch end
            jax.profiler.stop_trace()
            print(f"profiler trace -> {opt.profile}")

    means = _acc_mean(acc)
    print(
        f"Epoch: [{sess.epoch}][TRAINING] Total Time(s): {time.time() - t_epoch:.2f} "
        + fmt_metrics(means, prefix="avg.")
    )
    print()
    sess.logger("train").add({f"avg.{k} (train set)": v for k, v in means.items()})


def _eval_loop(sess: Session, mode: str):
    """Shared body of test() / eval() (`test.lua:19-95`,
    `eval.lua:18-84`). test additionally dumps stored outputs to
    testOutput_<EPOCH>.h5 (`test.lua:63-89`)."""
    opt = sess.opt
    split = "test" if mode == "test" or "eval" not in sess.loaders else "eval"
    if mode == "eval" and split == "test":
        print(
            "WARNING: -eval requested but this dataset provides no eval/val "
            "split; falling back to the TEST split (a second test pass)."
        )
    loader = sess.loaders[split]
    n_total = loader.size()
    if n_total == 0:
        print(f"WARNING: {split} split is empty — skipping {mode}()")
        return {}
    step = sess.test_step if mode == "test" else sess.eval_step
    print(f"==> doing epoch on {mode} data:")
    print(f"==> online epoch # {sess.epoch}")

    def specs():
        i = 1
        while i <= n_total:
            i2 = min(i + opt.batchSize - 1, n_total)
            yield ("get", split, i, i2, sess.epoch)
            i = i2 + 1

    metrics_fn = sess.test_metrics_fn if mode == "test" else sess.eval_metrics_fn
    # stored-output dumps only happen in test mode (`test.lua:63-89`);
    # eval must not pile the split's outputs up in host RAM — and when
    # nothing is stored, skip the device->host output transfer entirely
    collect = mode == "test"
    acc: Dict[str, tuple] = {}
    stored: Dict[str, list] = {}
    t0 = time.time()
    with jax.set_mesh(sess.mesh):
        for x, y in sess.pool.imap_specs(specs()):
            n = x.shape[0]
            # pad the ragged tail to the FULL batch shape: a merely
            # divisible tail would be a second input shape and recompile
            # the whole eval step (minutes for the ImageNet models)
            pad = opt.batchSize - n
            if pad:  # metrics recomputed on the true slice below
                xp = np.concatenate([x, np.repeat(x[-1:], pad, 0)])
                yp = np.concatenate([y, np.repeat(y[-1:], pad, 0)])
            else:
                xp, yp = x, y
            batch = sess._shard({"x": xp, "y": yp})
            metrics, out = step(sess.params, sess.stats, batch)
            if pad or collect:
                # multi-process: batch shards live on other hosts, so
                # all-gather before any host-side slice/dump (no-op
                # passthrough to numpy single-process)
                out = fetch_global(out)
            if pad:
                out = out[:n]
                metrics = metrics_fn(jnp.asarray(out), jnp.asarray(y))
            mvals = {k: float(v) for k, v in metrics.items()}
            _acc_update(acc, mvals, n)
            if collect:
                for k, v in sess.net.stored_outputs(np.asarray(out)).items():
                    stored.setdefault(k, []).append(np.asarray(v))

    means = _acc_mean(acc)
    label = "TESTING" if mode == "test" else "EVALUATION"
    print(
        f"Epoch: [{sess.epoch}][{label}] Total Time(s): {time.time() - t0:.2f} "
        + fmt_metrics(means, prefix="avg.")
    )
    print()
    sess.logger(mode).add({f"avg.{k} ({mode} set)": v for k, v in means.items()})

    if mode == "test" and stored and is_primary():
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                "-test dumps this model's outputs to testOutput_<epoch>.h5, "
                "which needs h5py (not installed)"
            ) from e

        path = os.path.join(opt.save, f"testOutput_{sess.epoch}.h5")
        os.makedirs(opt.save, exist_ok=True)
        with h5py.File(path, "w") as f:
            for k, chunks in stored.items():
                f.create_dataset(k, data=np.concatenate(chunks, axis=0))
        print(f"stored outputs -> {path}")
    return means


def test(sess: Session):
    return _eval_loop(sess, "test")


def evaluate(sess: Session):
    return _eval_loop(sess, "eval")


def run(sess: Session):
    """Epoch driver (`pipelines/standard/pipeline.lua:1-10`)."""
    from mgtpu.utils.checkpoint import save_checkpoint

    opt = sess.opt
    for epoch in range(opt.epochNumber, opt.nEpochs + 1):
        sess.epoch = epoch
        if opt.train:
            train(sess)
        if opt.eval and epoch % opt.nEpochsEval == 0:
            evaluate(sess)
        if opt.test and epoch % opt.nEpochsTest == 0:
            test(sess)
        stop_here = getattr(opt, "stopAfter", 0) and epoch >= opt.stopAfter
        # a -stopAfter epoch always checkpoints (resume must not lose
        # work when the stop point is off the -nEpochsSave cadence)
        if opt.train and (epoch % opt.nEpochsSave == 0 or stop_here):
            # gather FIRST, on every process: under -multihost -tensor
            # the param/momentum shards span processes (np.asarray on
            # them raises non-addressable), and the all-gather is a
            # collective — a primary-only gather would deadlock. A
            # fully-addressable or replicated tree passes through
            # untouched.
            p, s, o = (gather_tree(sess.params), gather_tree(sess.stats),
                       gather_tree(sess.opt_state))
            if getattr(opt, "multihost", False):
                # the PREVIOUS async write's failure is only discovered
                # at join time, and only the primary joins — broadcast
                # it so every process aborts together instead of the
                # peers hanging in the next collective until the distributed
                # timeout
                from jax.experimental import multihost_utils

                from mgtpu.utils.checkpoint import (join_pending_saves,
                                                    pending_save_failed)
                bad = np.float32(is_primary() and pending_save_failed())
                if float(multihost_utils.broadcast_one_to_all(bad)):
                    join_pending_saves()  # re-raises with the cause on primary
                    raise RuntimeError(
                        "primary's async checkpoint write failed; aborting"
                    )
            if is_primary():
                path = os.path.join(opt.save, f"model_{epoch}.ckpt")
                # async: the D2H fetch happens inside the call (donation
                # safety); the npz write overlaps the next epoch's
                # compute. main.py joins before process exit;
                # load_checkpoint joins before reading.
                save_checkpoint(path, p, s, o,
                                epoch, sess.meta, async_write=True)
                print(f"checkpoint -> {path}")
        if stop_here:
            # bounded partial run (-stopAfter): exit cleanly after this
            # epoch WITHOUT touching -nEpochs (which the LR schedules
            # read); -retrain/-epochNumber resumes from its checkpoint
            print(f"==> stopping after epoch {epoch} (-stopAfter)")
            break
