#!/usr/bin/env python
"""Serving latency/throughput sweep for the flagship R-MG-34 forward.

The reference has no serving story (research checkpoints only); this
measures mgtpu's production-serving surface per batch size: p50 call
latency and steady throughput in bf16.

  python tools/bench_serving.py [--no-fold-bn] [--batches 1 8 32 128]

One JSON line per batch row. Latency here includes the host
dispatch path, so the throughput column (amortized over CHUNK
back-to-back calls) is the device-meaningful number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNK = 20


def measure(fwd, params, stats, x):
    def sync(r):
        return r.block_until_ready()

    for _ in range(3):
        r = fwd(params, stats, x)
    sync(r)
    # latency: individually synced calls
    lats = []
    for _ in range(10):
        t0 = time.perf_counter()
        sync(fwd(params, stats, x))
        lats.append(time.perf_counter() - t0)
    lats.sort()
    p50 = lats[len(lats) // 2]
    # throughput: back-to-back dispatch, one sync
    t0 = time.perf_counter()
    for _ in range(CHUNK):
        r = fwd(params, stats, x)
    sync(r)
    thr = CHUNK * x.shape[0] / (time.perf_counter() - t0)
    return p50, thr


def main():
    import jax
    import jax.numpy as jnp

    from mgtpu.models import get_net

    ap = argparse.ArgumentParser()
    ap.add_argument("--no-fold-bn", action="store_true",
                    help="measure the unfolded eval graph instead of the "
                         "BN-folded serving graph tools/export_model.py "
                         "exports by default")
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 8, 32, 128])
    args = ap.parse_args()

    opt = types.SimpleNamespace(depth=34, compute_dtype=jnp.bfloat16)
    net = get_net("ilsvrc/rnmg")
    model = net.create_model(opt)
    params, stats = jax.jit(model.init)(jax.random.PRNGKey(0))

    # measure what serving actually runs: the BN-folded export graph
    # (mgtpu/ops/fold.py; exactness pinned in tests/test_fold_bn.py)
    folded = not args.no_fold_bn
    if folded:
        from mgtpu.ops.fold import fold_batchnorm

        params, stats = fold_batchnorm(model, params, stats)

    @jax.jit
    def fwd(p, s, x):
        y, _ = model.apply(p, s, x, train=False)
        return jnp.sum(y.astype(jnp.float32))

    for b in args.batches:
        x = jax.random.normal(jax.random.PRNGKey(1), (b, 224, 224, 3),
                              jnp.bfloat16)
        p50, thr = measure(fwd, params, stats, x)
        print(json.dumps({
            "dtype": "bf16", "batch": b, "folded": folded,
            "p50_latency_ms": round(p50 * 1e3, 2),
            "throughput_img_s": round(thr, 1),
        }), flush=True)

if __name__ == "__main__":
    main()
