"""Model analysis: parameter and multiply-add counts per netType.

The reference README publishes params/FLOPs tables (`README.md:85-92,
105-109`; the "FLOPs" column counts multiply-adds). This tool derives
both from the actual built model by walking the jaxpr of a forward
pass and summing conv_general_dilated / dot_general MACs — so the
numbers reflect what the code constructs, not a hand count.

Set MGTPU_NO_FUSED_EXCHANGE=1 to count the reference formulation
(materialized resample-concat, dense 9-tap up-convs); the default
counts the fused formulation, where the dilated up-conv fold makes the
MAC count look ~1.8x larger than the useful work (lhs-dilated convs
multiply by the inserted zeros unless the backend skips them).

Usage:
  python tools/model_info.py -netType cifar/nmg -nLayer 1 [-imageCrop 32]
  python tools/model_info.py -netType ilsvrc/rnmg -depth 34 -imageCrop 224
  python tools/model_info.py --all-cifar
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def count_macs(jaxpr) -> int:
    """Sum multiply-adds of all conv/dot eqns, recursing into calls."""
    macs = 0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "conv_general_dilated":
            out = eqn.outvars[0].aval.shape
            rhs = eqn.invars[1].aval.shape  # HWIO under our dim numbers
            dn = eqn.params["dimension_numbers"]
            # kernel spatial dims + input-feature dim from dim numbers
            kspec = dn.rhs_spec  # (out_f, in_f, *spatial) positions
            in_f = rhs[kspec[1]]
            spatial = [rhs[i] for i in kspec[2:]]
            taps = in_f
            for s in spatial:
                taps *= s
            n_out = 1
            for s in out:
                n_out *= s
            # rhs's in_f dim is already C_in/groups — no further division
            macs += n_out * taps
        elif prim in ("dot_general",):
            out = eqn.outvars[0].aval.shape
            lhs = eqn.invars[0].aval.shape
            (lc, _), _ = eqn.params["dimension_numbers"]
            k = 1
            for i in lc:
                k *= lhs[i]
            n_out = 1
            for s in out:
                n_out *= s
            macs += n_out * k
        for sub in eqn.params.values():
            if hasattr(sub, "jaxpr"):
                macs += count_macs(sub.jaxpr)
    return macs


def model_info(net_type: str, crop: int, **model_opts):
    import jax
    import jax.numpy as jnp

    from mgtpu.models import get_net
    from mgtpu.nn import param_count

    opt = types.SimpleNamespace(nEpochs=200, **model_opts)
    net = get_net(net_type)
    model = net.create_model(opt)
    params, stats = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    c_in = 1 if net_type.startswith("mnist-cluttered/") else 3
    x = jax.ShapeDtypeStruct((1, crop, crop, c_in), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda p, s, x: model.apply(p, s, x, train=False)[0]
    )(params, stats, x)
    return {
        "netType": net_type,
        **{k: v for k, v in model_opts.items() if v is not None},
        "input": crop,
        "params": param_count(params),
        "macs_per_image": count_macs(jaxpr.jaxpr),
        "formulation": "reference" if os.environ.get("MGTPU_NO_FUSED_EXCHANGE")
        else "fused",
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-netType", default=None)
    ap.add_argument("-nLayer", type=int, default=None)
    ap.add_argument("-depth", type=int, default=None)
    ap.add_argument("-shortcutType", default="B",
                    help="matches ilsvrc/prnmgseg's training default")
    ap.add_argument("-imageCrop", type=int, default=32)
    ap.add_argument("--all-cifar", action="store_true")
    args = ap.parse_args()

    if args.all_cifar:
        for nt in ("cifar/nmg", "cifar/rnmg"):
            for nl in (1, 2, 3, 4):
                print(json.dumps(model_info(nt, 32, nLayer=nl)))
        return
    kw = {}
    if args.nLayer is not None:
        kw["nLayer"] = args.nLayer
    if args.depth is not None:
        kw["depth"] = args.depth
    kw["shortcutType"] = args.shortcutType
    print(json.dumps(model_info(args.netType, args.imageCrop, **kw)))


if __name__ == "__main__":
    main()
