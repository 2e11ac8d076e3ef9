"""Benchmark of R-MG-34 (ilsvrc/rnmg depth 34) at 224 px, bf16, on one
NVIDIA GPU.

Prints ONE JSON line: the BN-folded serving forward (the graph
tools/export_model.py exports), the unfolded forward beside it in
interleaved windows, and the training step (fwd+bwd+SGD), each as the
median images/s over timed windows with its spread, plus the model FLOP
utilization of each against the card's bf16 peak. The object names the
device (platform, device_kind, count, and nvidia-smi's name and power
limit): a number is only meaningful beside the card and its limit.

  {"metric": ..., "value": N, "unit": "images/sec/device",
   "spread_pct": f,             # (max-min)/median over the timed windows
   "unfolded_value": N, "fold_vs_unfolded": f,
   "train_value": N, "train_spread_pct": f,
   "train_mfu": f, "infer_mfu": f, "train_ceiling": N,
   "platform": "gpu", "device_kind": ..., "device_count": N,
   "nvidia_smi": "<name>, <power limit>"}

MFU = img/s * FLOPs/img / bf16 peak, with FLOPs/img = 2 * MACs
(inference) or 3 * 2 * MACs (training: bwd costs ~2x fwd). MACs/img is
the reference-formulation count (5.760G for R-MG-34 at 224px, pinned
against the published 5.76G by tools/model_info.py +
tests/test_tools.py); the fused up-convs' dilated formulation would
inflate the count without representing more useful work.

A device that is not in the peak table is an error, not a default: the
MFU fields would otherwise look plausible while being wrong.

Usage: python bench.py [batch] [--no-train]
"""

import json
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp

# R-MG-34 @ 224px multiply-adds per image, reference formulation
# (tools/model_info.py with MGTPU_NO_FUSED_EXCHANGE=1; matches the
# reference README's 5.76 GFLOPs).
MACS_PER_IMAGE = 5.760e9

# Peaks per device, keyed by exact jax.devices()[0].device_kind. Source:
# NVIDIA H100 data sheet, SXM part, dense (no sparsity), at its 700 W
# power limit; a card set below that limit cannot hold these clocks, so
# every result also prints the card's power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(kind: str) -> dict:
    """The peak row for ``kind``; raises for any device not in PEAKS
    (CPU included)."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise SystemExit(
            f"bench.py: no peak rates for device_kind {kind!r}; known: "
            f"{sorted(PEAKS)}. Add a row with its source before measuring."
        ) from None


def nvidia_smi() -> str:
    """The card's name and power limit, from a child process that stays
    off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(l.strip() for l in r.stdout.strip().splitlines())


def _median_spread(samples):
    """(median, spread_pct) with spread = (max-min)/median: a delta
    inside the spread is run-to-run noise."""
    s = sorted(samples)
    n = len(s)
    med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    return med, 100.0 * (s[-1] - s[0]) / med


def _make_fwd(model):
    @jax.jit
    def fwd(p, s, x):
        y, _ = model.apply(p, s, x, train=False)
        return jnp.sum(y.astype(jnp.float32))

    return fwd


def _timed_window(fwd, params, stats, x, batch, iters):
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fwd(params, stats, x)
    r.block_until_ready()
    return batch * iters / (time.perf_counter() - t0)


def bench_infer_ab(model, a_tree, b_tree, batch, reps=5):
    """Interleaved A/B of two param/stat trees on the SAME jitted
    forward: windows alternate A,B,A,B,... within one process, so any
    drift (clock and power ramps) lands on both sides equally and the
    ratio of medians is attributable to the trees.

    Returns ((median_a, spread_a), (median_b, spread_b))."""
    fwd = _make_fwd(model)
    x = jax.random.normal(jax.random.PRNGKey(1), (batch, 224, 224, 3), jnp.bfloat16)
    for tree in (a_tree, b_tree):  # compile + warm both variants
        for _ in range(3):
            r = fwd(tree[0], tree[1], x)
        r.block_until_ready()
    iters = 30
    sa, sb = [], []
    for _ in range(reps):
        sa.append(_timed_window(fwd, a_tree[0], a_tree[1], x, batch, iters))
        sb.append(_timed_window(fwd, b_tree[0], b_tree[1], x, batch, iters))
    return _median_spread(sa), _median_spread(sb)


def bench_train(model, net, opt, params, stats, batch, reps=5,
                target_spread=3.0, max_reps=11):
    from mgtpu.train.optim import sgd_init
    from mgtpu.train.step import make_train_step

    step = jax.jit(
        make_train_step(model, net.create_loss(opt), net, iter_size=1),
        donate_argnums=(0, 1, 2),
    )
    opt_state = sgd_init(params)
    x = jax.random.normal(jax.random.PRNGKey(1), (batch, 224, 224, 3), jnp.bfloat16)
    y = (jax.random.uniform(jax.random.PRNGKey(2), (batch,)) * 1000).astype(jnp.int32)
    b = {"x": x, "y": y}
    for i in range(3):
        params, stats, opt_state, m = step(
            params, stats, opt_state, b, 0.1, 1e-4, jax.random.PRNGKey(i)
        )
    m["loss"].block_until_ready()
    # Adaptive rep count: if the spread across reps exceeds
    # target_spread, keep adding reps (up to max_reps) and report the
    # final spread — never trim samples.
    iters = 40
    samples = []
    while True:
        t0 = time.perf_counter()
        for i in range(iters):
            params, stats, opt_state, m = step(
                params, stats, opt_state, b, 0.1, 1e-4, jax.random.PRNGKey(i)
            )
        m["loss"].block_until_ready()
        samples.append(batch * iters / (time.perf_counter() - t0))
        if len(samples) >= reps:
            med, spread = _median_spread(samples)
            if spread <= target_spread or len(samples) >= max_reps:
                return med, spread


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    batch = int(args[0]) if args else 128
    with_train = "--no-train" not in sys.argv

    from mgtpu.models import get_net

    opt = types.SimpleNamespace(depth=34, compute_dtype=jnp.bfloat16)
    net = get_net("ilsvrc/rnmg")
    model = net.create_model(opt)
    params, stats = jax.jit(model.init)(jax.random.PRNGKey(0))
    # the jitted fns run unsharded on the default device, so this is a
    # one-device measurement by construction
    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind)
    peak = peaks["bf16_flops"]
    infer_flops = 2.0 * MACS_PER_IMAGE
    train_flops = 3.0 * infer_flops  # fwd + ~2x-fwd bwd

    # headline = the serving graph: BN folded into conv weights, the
    # default export configuration (tools/export_model.py); the
    # unfolded forward is kept alongside for round-over-round continuity
    from mgtpu.ops.fold import fold_batchnorm

    fp, fs = fold_batchnorm(model, params, stats)
    (ips, ips_spread), (uips, uspread) = bench_infer_ab(
        model, (fp, fs), (params, stats), batch
    )
    result = {
        "metric": "images/sec/device R-MG-34 224px inference "
                  "(batch %d, bf16, BN-folded serving graph)" % batch,
        "value": round(ips, 1),
        "unit": "images/sec/device",
        "spread_pct": round(ips_spread, 2),
        "unfolded_value": round(uips, 1),
        "unfolded_spread_pct": round(uspread, 2),
        "fold_vs_unfolded": round(ips / uips, 3),
        "fold_ab_interleaved": True,  # alternating windows, one process
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": nvidia_smi(),
        "infer_mfu": round(ips * infer_flops / peak, 4),
        "train_ceiling": round(peak / train_flops, 1),
    }
    print(
        f"inference (BN-folded serving graph): {ips:.1f} images/sec/device "
        f"({ips / uips:.2f}x the unfolded {uips:.1f})",
        file=sys.stderr,
    )
    if with_train:
        tips, tspread = bench_train(model, net, opt, params, stats, batch)
        result["train_value"] = round(tips, 1)
        result["train_unit"] = "images/sec/device fwd+bwd+sgd"
        result["train_spread_pct"] = round(tspread, 2)
        result["train_mfu"] = round(tips * train_flops / peak, 4)
        print(
            f"train fwd+bwd+sgd: {tips:.1f} images/sec/device (batch {batch}, "
            f"mfu {result['train_mfu']:.3f}, 100%-MFU ceiling "
            f"{result['train_ceiling']:.0f})",
            file=sys.stderr,
        )

    print(json.dumps(result))


if __name__ == "__main__":
    main()
