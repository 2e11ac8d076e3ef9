"""Run a StableHLO artifact produced by tools/export_model.py — the
minimal serving side, with no mgtpu model code on the path.

Usage:
  python tools/serve_exported.py model.shlo images.npy [--out preds.npy]
  python tools/serve_exported.py model.shlo --random  # smoke
"""

from __future__ import annotations

import argparse

import numpy as np


def main():
    import jax.numpy as jnp
    from jax import export as jexport

    ap = argparse.ArgumentParser()
    ap.add_argument("artifact")
    ap.add_argument("images", nargs="?", default=None)
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    with open(args.artifact, "rb") as f:
        exp = jexport.deserialize(bytearray(f.read()))
    (spec,) = exp.in_avals
    print(f"artifact expects {spec.shape} {spec.dtype}")
    if args.random or args.images is None:
        x = np.random.default_rng(0).normal(size=spec.shape).astype(np.float32)
    else:
        x = np.load(args.images)
    y = np.asarray(exp.call(jnp.asarray(x, spec.dtype)))
    print(f"output {y.shape} {y.dtype}; top-1 of first 5: {y[:5].argmax(-1)}")
    if args.out:
        np.save(args.out, y)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
