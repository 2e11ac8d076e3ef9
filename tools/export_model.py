"""Export a trained model's forward pass as a serialized StableHLO
artifact (jax.export) for serving without any mgtpu/Python model code.

The artifact closes over the checkpoint weights as constants, so the
serving side needs only `jax.export.deserialize(bytes).call(images)`
— on GPU or CPU. This is the JAX answer to the
reference's whole-model torch.save blobs (`multigpu.lua:105`,
relied on by the saliency pipeline): one self-contained file that
reproduces the forward pass, with the architecture compiled in instead
of pickled Lua modules.

Usage:
  python tools/export_model.py -netType ilsvrc/rnmg -depth 34 \
      -ckpt model_90.ckpt -batch 128 -imageCrop 224 -out rmg34.shlo
  # serving:
  python tools/serve_exported.py rmg34.shlo images.npy
"""

from __future__ import annotations

import argparse
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    from mgtpu.models import get_net
    from mgtpu.utils.checkpoint import load_checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("-netType", required=True)
    ap.add_argument("-ckpt", default=None, help="checkpoint; random init if omitted")
    ap.add_argument("-batch", type=int, default=128)
    ap.add_argument("-imageCrop", type=int, default=224)
    ap.add_argument("-channels", type=int, default=3)
    ap.add_argument("-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("-nLayer", type=int, default=None)
    ap.add_argument("-depth", type=int, default=None)
    ap.add_argument("-shortcutType", default="A")
    ap.add_argument("-out", required=True)
    ap.add_argument("-allow-pickle", dest="allow_pickle", action="store_true",
                    help="permit legacy pickle checkpoints (trusted files only)")
    ap.add_argument("-no-fold-bn", dest="fold_bn", action="store_false",
                    help="keep eval-mode BatchNorm as runtime normalize "
                         "passes instead of folding it into the conv "
                         "weights (mgtpu/ops/fold.py; folding is exact "
                         "and default-on for this inference-only export)")
    ap.add_argument("-platforms", nargs="*", default=None,
                    help="lowering platforms, e.g. -platforms cuda cpu "
                         "(default: the current backend)")
    args = ap.parse_args()

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    opt = types.SimpleNamespace(
        nEpochs=200, compute_dtype=dtype, shortcutType=args.shortcutType,
    )
    if args.nLayer is not None:
        opt.nLayer = args.nLayer
    if args.depth is not None:
        opt.depth = args.depth
    net = get_net(args.netType)
    model = net.create_model(opt)
    if args.ckpt:
        ckpt = load_checkpoint(args.ckpt, allow_pickle=args.allow_pickle)
        params, stats = ckpt["params"], ckpt["stats"]
    else:
        params, stats = jax.jit(model.init)(jax.random.PRNGKey(0))
    if args.fold_bn:
        # Exported artifacts are inference-only by construction, so the
        # eval-mode BN folds into the conv weights for free (one fewer
        # read+write of every conv output; exactness pinned in
        # tests/test_fold_bn.py).
        from mgtpu.ops.fold import fold_batchnorm

        params, stats = fold_batchnorm(model, params, stats)

    @jax.jit
    def fwd(x):
        y, _ = model.apply(params, stats, x, train=False)
        return y

    x_spec = jax.ShapeDtypeStruct(
        (args.batch, args.imageCrop, args.imageCrop, args.channels), dtype
    )
    exp = jexport.export(fwd, platforms=args.platforms)(x_spec)
    data = exp.serialize()
    with open(args.out, "wb") as f:
        f.write(data)
    kind = args.dtype
    if args.fold_bn:
        kind += "+foldBN"
    print(f"exported {args.netType} fwd (batch {args.batch}, {kind}) "
          f"-> {args.out} ({len(data) / 1e6:.1f} MB, "
          f"platforms {exp.platforms})")


if __name__ == "__main__":
    main()
