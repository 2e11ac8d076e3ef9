"""Smoke test of the main path on NVIDIA GPUs.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # the published 4-GPU recipe, and nothing else

One card runs, in one process:

  1. device     - refuses anything but a GPU; prints the card, its power
                  limit (nvidia-smi), versions, XLA_FLAGS, the compile cache
  2. train      - R-MG-34 through ``mgtpu.main.main`` with the flags of
                  scripts/ilsvrc/rnmg.sh on one card, a few steps and a
                  short -test, once as published (float32) and once bf16
  3. reference  - eval logits and train-mode loss at batch 8 in bf16 and in
                  float32 at the default precision, each against float32 at
                  ``highest`` precision
  4. serving    - the BN-folded bf16 forward (the graph
                  tools/export_model.py exports) at batch 1 and 128

``--four`` runs the recipe's 4-GPU data-parallel step (-nGPU 4 -batchSize
64 -iterSize 4) and the same global batch on one card, and compares them.

Any failure exits non-zero before the last line. The last line of stdout
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Times printed here are smoke timings of a cold or warm process, not
benchmark numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# scripts/ilsvrc/rnmg.sh without -nGPU / -nEpochs / -epochSize, which each
# phase sets; R-MG-34 at 224 px, global micro-batch 64, 4 micro-batches
# per update.
RECIPE = [
    "-data", "synthetic", "-dataset", "ilsvrc", "-nDonkeys", "10",
    "-batchSize", "64", "-iterSize", "4", "-colorspace", "bgr",
    "-netType", "ilsvrc/rnmg", "-depth", "34",
]

# Tolerances, relative L2 over logits centred per row (the model emits
# log-probabilities; centring removes the shared log-sum-exp so the norm
# measures the logits, not a constant offset).
# - bf16 keeps 8 mantissa bits (unit roundoff 2^-9 = 2e-3). R-MG-34 chains
#   ~70 convs, so rounding of activations and weights adds up to about
#   1e-2; 3e-2 leaves room for one unlucky layer without hiding a wrong
#   kernel, which lands at O(1).
# - TF32 keeps 10 mantissa bits in the products (2^-11 = 5e-4) with float32
#   accumulation and float32 activations between convs, so its error stays
#   near one layer's rounding: 5e-3.
# - the loss is a mean NLL near ln(1000) = 6.9; 1e-2 absolute is 1.5e-3
#   relative, the size of the bf16 logit error after averaging.
# On an H100 80GB HBM3 (700 W) R-MG-34 measured 4.1e-3 (bf16) and 5.3e-4
# (TF32) logits rel-L2, and 1.2e-3 / 8.8e-5 loss difference.
TOL_BF16 = 3e-2
TOL_TF32 = 5e-3
TOL_LOSS = 1e-2
# 4 GPUs vs 1 on the same global batch, one update: both runs are float32
# at the default precision (TF32), and cuDNN may pick other algorithms for
# the per-card batch of 16 than for 64. The step's loss is computed at the
# same params, so it must agree like two TF32 forwards (1e-3 of a loss
# near 9); the parameter change within 2e-2 relative L2 (TF32 gradient
# error compounded over fwd + bwd). A DP fault (per-card BN moments, a
# gradient not averaged over the cards) lands at 1e-1 or more. One update
# only: at the recipe's lr 0.1 from random weights the second step
# amplifies TF32 noise, and on 4 H100s (400 W) two updates already
# differed by 5.2e-2 in the parameter change with the first loss equal to
# 2e-5. On 4 virtual CPU devices in exact float32 a tiny net's parameter
# change agrees to 5e-6 (tests/test_chip_smoke.py pins 1e-3); scaled by
# the TF32/float32 roundoff ratio (2^-11 / 2^-24 = 8192) that is 4e-2,
# the size seen on the cards, so the gap is rounding, not a DP fault.
TOL_DP_LOSS = 1e-3
TOL_DP_PARAMS = 2e-2


class SmokeFailure(RuntimeError):
    pass


def ok_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref|| in float64; inf when ref is zero and got
    is not, nan when either holds a nan."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise SmokeFailure(f"shape {got.shape} vs reference {ref.shape}")
    num = np.linalg.norm((got - ref).ravel())
    den = np.linalg.norm(ref.ravel())
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return float(num / den)


def check(name: str, value: float, tol: float) -> float:
    """Print ``value`` beside its tolerance; raise unless value <= tol
    (a nan fails)."""
    ok = bool(value <= tol)
    print(f"  {name}: {value:.3e} (tolerance {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name} = {value!r} exceeds {tol!r}")
    return value


def centred(out):
    out = np.asarray(out, np.float64)
    return out - out.mean(axis=-1, keepdims=True)


class CompileClock:
    """Sums XLA backend-compile seconds and persistent-cache hits from
    JAX's monitoring events; ``lap()`` returns and resets them."""

    def __init__(self):
        import jax

        self.seconds, self.hits = 0.0, 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1

    def lap(self):
        out = (self.seconds, self.hits)
        self.seconds, self.hits = 0.0, 0
        return out

    def report(self, what: str):
        s, h = self.lap()
        print(f"  compile {what}: {s:.1f} s in XLA, {h} persistent-cache hits")


class _Tee(io.TextIOBase):
    def __init__(self, sink):
        self.sink, self.buf = sink, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.sink.write(s)

    def flush(self):
        self.sink.flush()


_STEP = re.compile(r"Epoch: \[\d+\]\[(\d+)/\d+\]\tRun:([0-9.]+)s .*?\bloss:(\S+)")


def run_main(argv):
    """``mgtpu.main.main(argv)`` in this process, echoing its output.
    Returns (session, [(step, run seconds, loss)])."""
    from mgtpu.main import main

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        sess = main(argv)
    steps = [(int(a), float(b), float(c)) for a, b, c in _STEP.findall(tee.buf.getvalue())]
    return sess, steps


def memory_line(what: str, compiled):
    m = compiled.memory_analysis()
    print(f"  memory_analysis {what}: arguments {m.argument_size_in_bytes}, "
          f"outputs {m.output_size_in_bytes}, temp {m.temp_size_in_bytes}, "
          f"aliased {m.alias_size_in_bytes}, code {m.generated_code_size_in_bytes} bytes")


def peak_line():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use (device 0, process so far): "
          f"{stats.get('peak_bytes_in_use', 'not reported')}")


def train_step_compiled(sess):
    """The session's jitted train step, compiled for the shapes it ran
    (an in-memory or persistent-cache hit, not a second compile)."""
    import jax

    opt = sess.opt
    it = opt.iterSize
    lead = (it, opt.batchSize) if it > 1 else (opt.batchSize,)
    host = {"x": np.zeros(lead + (opt.imageCrop, opt.imageCrop, 3), np.float32),
            "y": np.zeros(lead, np.int32)}
    batch = sess._shard(host, 1 if it > 1 else 0)
    hyper = sess.lr_wd()
    with jax.set_mesh(sess.mesh):
        return sess.train_step.lower(
            sess.params, sess.stats, sess.opt_state, batch,
            hyper["lr"], hyper["wd"], jax.random.PRNGKey(0),
        ).compile()


# ---------------------------------------------------------------- phases


def phase_device(min_count: int):
    import jax

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        raise SmokeFailure(f"JAX found no GPU (platform {platform!r}); "
                           "this smoke runs on NVIDIA GPUs only")
    if len(devs) < min_count:
        raise SmokeFailure(f"needs {min_count} GPUs, JAX found {len(devs)}")
    print("== device")
    print(f"  device_kind: {devs[0].device_kind}, count: {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print("  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    import jaxlib

    print(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"  XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    from mgtpu.main import init_compile_cache
    from mgtpu.native import available

    print(f"  compile cache: {init_compile_cache()}")
    print(f"  host data path: {'native mgdata library' if available() else 'Python/Pillow fallback'}")
    return devs[0]


def phase_train(clock, out: str, dtype: str, recipe=RECIPE, steps: int = 3):
    print(f"== train ({dtype}, {' '.join(recipe)} -nGPU 1)")
    argv = recipe + [
        "-nGPU", "1", "-nEpochs", "1", "-epochSize", str(steps),
        "-synthSize", "256", "-dtype", dtype, "-train", "-test",
        "-cache", os.path.join(out, f"train_{dtype}"),
    ]
    clock.lap()
    t0 = time.perf_counter()
    sess, losses = run_main(argv)
    wall = time.perf_counter() - t0
    clock.report(f"train+test ({dtype})")
    if [s for s, _, _ in losses] != list(range(1, steps + 1)):
        raise SmokeFailure(f"expected {steps} train steps, parsed {losses}")
    for step, run_s, loss in losses:
        print(f"  step {step}: loss {loss:.5f}, smoke step time {run_s:.3f} s")
        if not np.isfinite(loss):
            raise SmokeFailure(f"step {step} loss {loss}")
    print(f"  smoke wall time of the whole run: {wall:.1f} s")
    memory_line(f"train step ({dtype})", train_step_compiled(sess))
    clock.report("of that step again, for memory_analysis")
    peak_line()


def _forward_fns(model32, model16):
    """jitted (eval logits, train-mode loss) at batch 8, per precision."""
    import jax
    import jax.numpy as jnp

    from mgtpu.models.base import nll_loss

    def make(model):
        def f(p, s, x, y):
            out, _ = model.apply(p, s, x, train=False)
            tout, _ = model.apply(p, s, x, train=True, rng=jax.random.PRNGKey(0))
            return out.astype(jnp.float32), nll_loss(tout, y)

        return jax.jit(f)

    return make(model32), make(model16)


def phase_reference(clock, model32, model16, params, stats, x, y):
    import jax

    print(f"== reference (batch {x.shape[0]}, {x.shape[1]} px; float32 'highest' is the reference)")
    f32, f16 = _forward_fns(model32, model16)
    with jax.default_matmul_precision("highest"):
        ref_out, ref_loss = jax.device_get(f32(params, stats, x, y))
    tf_out, tf_loss = jax.device_get(f32(params, stats, x, y))
    bf_out, bf_loss = jax.device_get(f16(params, stats, x, y))
    clock.report("reference forwards")
    for name, a in (("highest", ref_out), ("tf32", tf_out), ("bf16", bf_out)):
        if not np.all(np.isfinite(a)):
            raise SmokeFailure(f"{name} logits not finite")
    print(f"  reference loss {float(ref_loss):.6f}, tf32 {float(tf_loss):.6f}, "
          f"bf16 {float(bf_loss):.6f}")
    check("tf32 logits rel-L2", rel_l2(centred(tf_out), centred(ref_out)), TOL_TF32)
    check("bf16 logits rel-L2", rel_l2(centred(bf_out), centred(ref_out)), TOL_BF16)
    check("tf32 |loss - ref|", abs(float(tf_loss) - float(ref_loss)), TOL_LOSS)
    check("bf16 |loss - ref|", abs(float(bf_loss) - float(ref_loss)), TOL_LOSS)
    return ref_out


def phase_serving(clock, model16, params, stats, x128, ref_head):
    """Folded bf16 forward at batch 1 and 128; the reference is the
    unfolded float32 'highest' forward of phase 3 over x128[:len(ref_head)]
    (eval-mode BN is per sample, so rows do not depend on the batch)."""
    import jax
    import jax.numpy as jnp

    from mgtpu.ops.fold import fold_batchnorm

    print(f"== serving (BN-folded, bf16; compared on the first {len(ref_head)} rows)")
    fp, fs = fold_batchnorm(model16, params, stats)
    fwd = jax.jit(lambda p, s, x: model16.apply(p, s, x, train=False)[0].astype(jnp.float32))
    xb = jnp.asarray(x128, jnp.bfloat16)
    out1 = np.asarray(fwd(fp, fs, xb[:1]))
    out128 = np.asarray(fwd(fp, fs, xb))
    clock.report("folded forwards")
    if out128.shape != (x128.shape[0], ref_head.shape[-1]) or not np.all(np.isfinite(out128)):
        raise SmokeFailure(f"batch-128 output shape {out128.shape} or values not finite")
    n = len(ref_head)
    check("batch 1 rel-L2 vs unfolded highest", rel_l2(centred(out1), centred(ref_head[:1])), TOL_BF16)
    check(f"batch 128 rel-L2 vs unfolded highest (rows 0..{n - 1})",
          rel_l2(centred(out128[:n]), centred(ref_head)), TOL_BF16)
    memory_line("folded forward batch 128", fwd.lower(fp, fs, xb).compile())
    clock.report("of that forward again, for memory_analysis")
    peak_line()


def dp_compare(base_argv, n: int, out: str, steps: int = 2):
    """The same global batch through ``-nGPU n`` and ``-nGPU 1``: the
    loss of every step and the parameter change must agree. Returns
    (max |loss difference|, relative L2 of the parameter changes)."""
    import jax

    common = base_argv + ["-nEpochs", "1", "-epochSize", str(steps),
                          "-nEpochsSave", "2", "-train"]
    runs = {}
    for k in (n, 1):
        sess, losses = run_main(common + ["-nGPU", str(k), "-cache", os.path.join(out, f"dp{k}")])
        if sess.mesh.shape["data"] != k:
            raise SmokeFailure(f"-nGPU {k} ran on a data mesh of {sess.mesh.shape['data']}")
        runs[k] = ([l for _, _, l in losses], jax.device_get(sess.params), sess)
    if len(runs[n][0]) != steps or len(runs[1][0]) != steps:
        raise SmokeFailure(f"parsed losses {runs[n][0]} / {runs[1][0]}")
    sess1 = runs[1][2]
    p0 = jax.device_get(jax.jit(sess1.model.init)(jax.random.PRNGKey(sess1.opt.manualSeed))[0])
    leaves = lambda t: np.concatenate([np.ravel(np.asarray(a, np.float64))
                                       for a in jax.tree.leaves(t)])
    d_n = leaves(runs[n][1]) - leaves(p0)
    d_1 = leaves(runs[1][1]) - leaves(p0)
    loss_diff = max(abs(a - b) for a, b in zip(runs[n][0], runs[1][0]))
    for i, (a, b) in enumerate(zip(runs[n][0], runs[1][0]), 1):
        print(f"  step {i}: loss {n} devices {a:.6f}, 1 device {b:.6f}")
    if not np.all(np.isfinite(d_n)) or not np.any(d_1):
        raise SmokeFailure("parameters not finite, or unchanged by the steps")
    return loss_diff, rel_l2(d_n, d_1)


def phase_four(clock, out: str):
    print("== four GPUs (scripts/ilsvrc/rnmg.sh: -nGPU 4 -batchSize 64 -iterSize 4) "
          "vs one GPU, same global batch")
    loss_diff, prel = dp_compare(RECIPE, 4, out, steps=1)
    clock.report("DP-4 and 1-GPU runs")
    check("max |loss 4 GPUs - loss 1 GPU|", loss_diff, TOL_DP_LOSS)
    check("param change rel-L2, 4 GPUs vs 1", prel, TOL_DP_PARAMS)
    peak_line()


def run(four: bool) -> str:
    dev = phase_device(4 if four else 1)
    import jax

    clock = CompileClock()
    out = tempfile.mkdtemp(prefix="chip_smoke_")
    print(f"  run directory: {out}")
    try:
        if four:
            phase_four(clock, out)
            return ok_line(dev.platform, dev.device_kind, len(jax.devices()))
        phase_train(clock, out, "float32")
        phase_train(clock, out, "bfloat16")

        import jax.numpy as jnp

        from mgtpu.models.ilsvrc.rnmg import build_ilsvrc_rnmg

        seed = 0
        model32 = build_ilsvrc_rnmg(34)
        model16 = build_ilsvrc_rnmg(34, dtype=jnp.bfloat16)
        params, stats = jax.jit(model32.init)(jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)
        x128 = rng.standard_normal((128, 224, 224, 3)).astype(np.float32)
        x, y = x128[:8], rng.integers(0, 1000, 8).astype(np.int32)
        ref_out = phase_reference(clock, model32, model16, params, stats, x, y)
        phase_serving(clock, model16, params, stats, x128, ref_out)
        return ok_line(dev.platform, dev.device_kind, len(jax.devices()))
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU data-parallel recipe and its 1-GPU comparison")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        line = run(args.four)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"== all phases passed in {time.perf_counter() - t0:.1f} s")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
