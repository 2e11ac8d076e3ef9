"""Fold eval-mode BatchNorm into the preceding conv's weights.

Serving/export-path optimization (no reference counterpart — the
reference serves train-mode graphs straight from torch.save blobs; the
BN semantics being preserved are `nn.SpatialBatchNormalization` eval
mode, `/root/reference/models/cifar/nmg.lua:23`):

    BN_eval(conv(x, W) + b) = conv(x, W * a) + ((b - mean) * a + beta)
    with a = gamma / sqrt(var + eps)        (per output channel)

so every BN normalize pass disappears from the inference graph — one
fewer full read+write of each conv's output tensor unless the compiler
already fuses the affine into the conv epilogue. ReLU stays where it
was.

The fold is a pure (params, stats) -> (params, stats) transform: folded
conv weights absorb `a`, and the BN's params/stats nodes become EMPTY
dicts — a static pytree-structure marker that `nn.BatchNorm.apply`
recognizes and skips (and refuses under train=True). Layers the walker
does not recognize are left untouched, which stays numerically correct:
their BNs keep their stats and still normalize at runtime.

Usage: `fold_batchnorm(model, params, stats)`; wired into
tools/export_model.py (default on) and the serving benches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mgtpu.nn import BatchNorm, ConvBN, Sequential, UpConvBN


def _fold_convbn(layer, p, s):
    """One Conv->BN (or ConvTranspose->BN) unit: absorb the BN affine
    into the conv kernel/bias; the kernel's output channel is the LAST
    axis for both HWIO conv and HWIO conv_transpose weights."""
    bn_p, bn_s = p["bn"], s["bn"]
    if not bn_s:  # already folded
        return p, s
    conv_layer = layer.conv if isinstance(layer, ConvBN) else layer.upconv
    # The BN offset lands in the conv bias, so the conv must own a "b"
    # param (Conv only adds one when self.bias; ConvTranspose always
    # does). The params are the ground truth — an attribute check would
    # mis-classify conv types without a `bias` field. Hard raise, not
    # assert: folding must fail loudly under `python -O` too, because a
    # silently dropped BN offset (beta - mean*a) means wrong outputs.
    if "b" not in p["conv"]:
        raise ValueError(
            f"cannot fold BN into bias-less {type(conv_layer).__name__}: "
            "no bias param to absorb the BN offset (beta - mean*a)"
        )
    a = bn_p["scale"] * jax.lax.rsqrt(bn_s["var"] + layer.bn.eps)
    w = p["conv"]["w"]
    new_w = (w * a).astype(w.dtype)
    b = p["conv"]["b"]
    new_b = (bn_p["bias"] + (b - bn_s["mean"]) * a).astype(b.dtype)
    new_conv = dict(p["conv"])
    new_conv["w"], new_conv["b"] = new_w, new_b
    return {"conv": new_conv, "bn": {}}, {"bn": {}}


def _fold_list(layers, p, s):
    new_p, new_s = dict(p), dict(s)
    for i, sub in enumerate(layers):
        k = str(i)
        if sub is None or k not in p:
            continue
        new_p[k], new_s[k] = _fold(sub, p[k], s[k])
    return new_p, new_s


def _fold_keyed(pairs, p, s):
    """pairs: (param_key, child) where child is a layer or a list of
    per-scale layers; keys absent from the params dict are skipped
    (e.g. a ResBlock without a conv shortcut)."""
    new_p, new_s = dict(p), dict(s)
    for k, child in pairs:
        if child is None or k not in p:
            continue
        if isinstance(child, list):
            new_p[k], new_s[k] = _fold_list(child, p[k], s[k])
        else:
            new_p[k], new_s[k] = _fold(child, p[k], s[k])
    return new_p, new_s


def _fold(layer, p, s):
    # Leaf fold targets.
    if isinstance(layer, (ConvBN, UpConvBN)):
        return _fold_convbn(layer, p, s)
    if isinstance(layer, BatchNorm):
        return p, s  # standalone BN: nothing to fold into

    # Import composites lazily (ops.mg imports nn; fold sits beside ops).
    from mgtpu.ops.mg import (MgConv, MgConvInput, MgResidual, MgStem7x7,
                              MgUpConv, PerScale, TailOp)

    if isinstance(layer, Sequential):
        return _fold_list(layer.layers, p, s)
    if isinstance(layer, PerScale):
        return _fold_list(layer.layers, p, s)
    if isinstance(layer, (MgConvInput, MgStem7x7, MgConv)):
        return _fold_list(layer.convs, p, s)
    if isinstance(layer, MgUpConv):
        return _fold_list(layer.ups, p, s)
    if isinstance(layer, TailOp):
        return _fold(layer.op, p, s)  # shares the op's param tree
    if isinstance(layer, MgResidual):
        return _fold_keyed(
            [("s1", layer.stage1), ("s2", layer.stage2), ("sc", layer.shortcuts)],
            p, s,
        )

    # models/common.ResBlock and the recursive U-Net levels: duck-typed
    # on their init() param keys (attribute name == key except ResBlock).
    if hasattr(layer, "conv1") and hasattr(layer, "shortcut"):  # ResBlock
        return _fold_keyed(
            [("c1", layer.conv1), ("c2", layer.conv2), ("sc", layer.shortcut)],
            p, s,
        )
    if hasattr(layer, "conv1") and hasattr(layer, "sub"):  # unet/unmg _Level
        return _fold_keyed(
            [("conv1", layer.conv1), ("sub", layer.sub),
             ("conv2", getattr(layer, "conv2", None)),
             ("up", getattr(layer, "up", None)),
             ("head", getattr(layer, "head", None))],
            p, s,
        )

    # Whole-model wrappers that delegate their param tree verbatim.
    if hasattr(layer, "seq"):  # models/common.MgNet
        return _fold(layer.seq, p, s)
    if hasattr(layer, "root"):  # UnetModel / UnmgModel
        return _fold(layer.root, p, s)

    # Unknown / parameterless layer: leave untouched (still correct —
    # any BN inside keeps its stats and normalizes at runtime).
    return p, s


def fold_batchnorm(model, params, stats):
    """Return (params, stats) with every recognized Conv->BN pair folded.
    Eval/serving only: `nn.BatchNorm.apply` raises if a folded tree is
    used with train=True. Exactness vs the unfolded eval forward is
    pinned in tests/test_fold_bn.py."""
    return _fold(model, params, stats)
