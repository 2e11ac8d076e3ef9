"""Minimal functional layer library (NHWC).

Every layer is a small Python object with

    init(key)  -> (params, stats)        two parallel pytrees
    apply(params, stats, x, *, train=False, rng=None) -> (y, new_stats)

``params`` is the trainable tree (differentiated), ``stats`` carries
non-trainable state (batch-norm running moments). Layers without state
return ``{}`` for stats.

Semantics mirror the Torch7 modules used by the reference
(`/root/reference/models/cifar/nmg.lua:18-29` ConvBNReLU,
`nn.SpatialBatchNormalization`, `optim.sgd` init conventions) but the
implementation is idiomatic JAX: NHWC layout, HWIO conv weights that
XLA hands to cuDNN or its own conv emitters as they are, fp32 master
params with an optional bf16 compute dtype.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

Params = Any
Stats = Any


class Rngs:
    """Trace-time rng splitter threaded through apply() for dropout."""

    def __init__(self, key):
        self._key = key

    def next(self):
        if self._key is None:
            raise ValueError("this model needs an rng (dropout in train mode)")
        self._key, sub = jax.random.split(self._key)
        return sub


def _as_rngs(rng) -> Optional[Rngs]:
    if rng is None or isinstance(rng, Rngs):
        return rng
    return Rngs(rng)


def cast_to(x, dtype):
    if dtype is None or x.dtype == dtype:
        return x
    return x.astype(dtype)


@dataclass
class Conv:
    """2D convolution, NHWC/HWIO, stride/padding per the reference convs.

    MSR (fan-out) init: std = sqrt(2 / (k*k*c_out)), zero bias — matching
    the reference's MSRinit (`models/cifar/nmg.lua:197-210`).

    Precision policy: no conv or matmul in this library sets a
    precision. Float32 compute (``dtype=None``, the `-dtype float32`
    default) runs at XLA's default precision, which on Ampere and later
    NVIDIA GPUs is TF32 (about three decimal digits in the products,
    float32 accumulation). bf16 compute (``dtype=jnp.bfloat16``) runs
    bf16 operands as it always has. A float32 reference that must be
    exact wraps its call in ``jax.default_matmul_precision("highest")``.
    """

    c_in: int
    c_out: int
    k: int = 3
    stride: int = 1
    pad: Optional[int] = None  # default: k==1 -> 0 else 1 (reference rule)
    bias: bool = True
    init_mode: str = "msr"  # "msr" | "torch" (uniform 1/sqrt(fan_in))
    dtype: Optional[Any] = None  # compute dtype (e.g. jnp.bfloat16)

    def __post_init__(self):
        if self.pad is None:
            self.pad = 0 if self.k == 1 else 1

    def init(self, key):
        kw, kb = jax.random.split(key)
        if self.init_mode == "msr":
            n = self.k * self.k * self.c_out
            std = math.sqrt(2.0 / n)
            w = std * jax.random.normal(
                kw, (self.k, self.k, self.c_in, self.c_out), jnp.float32
            )
            b = jnp.zeros((self.c_out,), jnp.float32)
        else:  # torch default: uniform(-s, s), s = 1/sqrt(k*k*c_in)
            s = 1.0 / math.sqrt(self.k * self.k * self.c_in)
            w = jax.random.uniform(
                kw, (self.k, self.k, self.c_in, self.c_out), jnp.float32, -s, s
            )
            b = jax.random.uniform(kb, (self.c_out,), jnp.float32, -s, s)
        p = {"w": w}
        if self.bias:
            p["b"] = b
        return p, {}

    def apply(self, p, s, x, *, train=False, rng=None):
        w = cast_to(p["w"], self.dtype)
        x = cast_to(x, self.dtype)
        y = jax.lax.conv_general_dilated(
            x,
            w,
            window_strides=(self.stride, self.stride),
            padding=[(self.pad, self.pad), (self.pad, self.pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        if self.bias:
            y = y + cast_to(p["b"], y.dtype)
        return y, s


@dataclass
class ConvTranspose:
    """Transposed conv (Torch SpatialFullConvolution 2x2/2 in the U-Nets,
    `models/mnist-cluttered/unmg.lua:35-40`). Torch-default uniform init
    (the reference's MSRinit does not touch FullConvolution modules)."""

    c_in: int
    c_out: int
    k: int = 2
    stride: int = 2
    dtype: Optional[Any] = None

    def init(self, key):
        kw, kb = jax.random.split(key)
        s = 1.0 / math.sqrt(self.k * self.k * self.c_in)
        w = jax.random.uniform(
            kw, (self.k, self.k, self.c_in, self.c_out), jnp.float32, -s, s
        )
        b = jax.random.uniform(kb, (self.c_out,), jnp.float32, -s, s)
        return {"w": w, "b": b}, {}

    def apply(self, p, s, x, *, train=False, rng=None):
        w = cast_to(p["w"], self.dtype)
        x = cast_to(x, self.dtype)
        y = jax.lax.conv_transpose(
            x,
            w,
            strides=(self.stride, self.stride),
            padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        y = y + cast_to(p["b"], y.dtype)
        return y, s


def _bn_axes_n(x):
    axes = tuple(range(x.ndim - 1))  # all but channel
    n = 1
    for a in axes:
        n *= x.shape[a]
    return axes, float(n)


def _bn_train_fwd(x, scale, bias, eps):
    """One-pass batch moments (E[x^2] - E[x]^2, fp32 accumulation — the
    cuDNN-style single read XLA multi-output-fuses) + affine normalize.
    Returns ((y, mean, var), residuals).

    Precision contract: the one-pass formula cancels catastrophically
    when |mean| >> sigma (fp32 loses the variance once mean^2/var
    approaches 1/ulp ~ 1e7). Every BatchNorm in this zoo normalizes a
    convolution's output, whose statistics are O(1), so the fused
    single read is the right trade; a model that batch-norms raw
    wide-range input should normalize its data instead (or set
    MGTPU_BN_NAIVE=1 for the two-pass formulation)."""
    xf = x.astype(jnp.float32)
    axes, n = _bn_axes_n(x)
    mean = jnp.mean(xf, axis=axes)
    meansq = jnp.mean(xf * xf, axis=axes)
    var = jnp.maximum(meansq - mean * mean, 0.0)
    inv = jax.lax.rsqrt(var + eps)
    a = inv * scale
    y = (xf * a + (bias - mean * a)).astype(x.dtype)
    return (y, mean, var), (x, mean, inv, scale)


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def _bn_train(x, scale, bias, eps):
    return _bn_train_fwd(x, scale, bias, eps)[0]


def _bn_train_bwd(eps, res, cts):
    """Canonical BN backward: exactly two reductions (sum dy, sum dy*xhat
    — one fused pass over dy and x) + one elementwise pass for dx.
    Autodiff of the moment formulation produces 4-5 passes; this is the
    measured-hot path of the train step (convert_reduce fusions were 25%
    of R-MG-34 step time).

    The mean/var outputs exist only to feed the running-stat update,
    which is a non-differentiated aux of the train step (mgtpu/train/
    step.py: stats ride through jax.grad(has_aux=True)), so their
    cotangents are structurally zero and are ignored here."""
    x, mean, inv, scale = res
    gy, _gmean, _gvar = cts
    xf = x.astype(jnp.float32)
    gf = gy.astype(jnp.float32)
    axes, n = _bn_axes_n(x)
    xhat = (xf - mean) * inv
    sum_dy = jnp.sum(gf, axis=axes)
    sum_dy_xhat = jnp.sum(gf * xhat, axis=axes)
    dx = (scale * inv) * (gf - sum_dy / n - xhat * (sum_dy_xhat / n))
    return dx.astype(x.dtype), sum_dy_xhat, sum_dy


_bn_train.defvjp(lambda x, scale, bias, eps: _bn_train_fwd(x, scale, bias, eps),
                 _bn_train_bwd)


@dataclass
class BatchNorm:
    """Spatial batch norm with running stats.

    Matches `nn.SpatialBatchNormalization(c, eps)`: train uses batch
    moments (biased var), running stats update with momentum 0.1 and
    unbiased variance; eval normalizes with running stats. Scale init 1,
    bias 0 (reference BNInit, `models/cifar/rnmg.lua:358-363`).
    Normalization is computed in fp32 regardless of compute dtype; the
    train path uses a custom VJP (2 reductions in backward instead of
    autodiff's 4-5). Set MGTPU_BN_NAIVE=1 to fall back to the autodiff
    two-pass formulation for comparison/debugging.
    """

    c: int
    eps: float = 1e-5
    momentum: float = 0.1

    def init(self, key):
        p = {
            "scale": jnp.ones((self.c,), jnp.float32),
            "bias": jnp.zeros((self.c,), jnp.float32),
        }
        s = {
            "mean": jnp.zeros((self.c,), jnp.float32),
            "var": jnp.ones((self.c,), jnp.float32),
        }
        return p, s

    def apply(self, p, s, x, *, train=False, rng=None):
        if not s:
            # Folded into the preceding conv (ops/fold.py replaced this
            # BN's params/stats with empty dicts — a STATIC structure
            # marker, so this branch resolves at trace time). Eval-only
            # by construction: batch moments of the folded conv's output
            # are not the moments the fold consumed.
            if train:
                raise ValueError(
                    "BatchNorm was folded (ops/fold.py) — folded params "
                    "serve eval/inference only, not training"
                )
            return x, s
        if train:
            if os.environ.get("MGTPU_BN_NAIVE"):
                xf = x.astype(jnp.float32)
                axes = tuple(range(x.ndim - 1))
                mean = jnp.mean(xf, axis=axes)
                var = jnp.var(xf, axis=axes)
                inv = jax.lax.rsqrt(var + self.eps) * p["scale"]
                y = (xf * inv + (p["bias"] - mean * inv)).astype(x.dtype)
            else:
                y, mean, var = _bn_train(x, p["scale"], p["bias"], self.eps)
            # running stats are non-differentiated state: stop_gradient
            # enforces structurally what _bn_train_bwd assumes (it drops
            # the mean/var cotangents) — a future caller differentiating
            # through new_s gets zeros by contract, not silent garbage
            mean = jax.lax.stop_gradient(mean)
            var = jax.lax.stop_gradient(var)
            n = np.prod([x.shape[a] for a in range(x.ndim - 1)])
            unbiased = var * (n / max(n - 1, 1))
            new_s = {
                "mean": (1 - self.momentum) * s["mean"] + self.momentum * mean,
                "var": (1 - self.momentum) * s["var"] + self.momentum * unbiased,
            }
            return y, new_s
        xf = x.astype(jnp.float32)
        inv = jax.lax.rsqrt(s["var"] + self.eps) * p["scale"]
        y = xf * inv + (p["bias"] - s["mean"] * inv)
        return y.astype(x.dtype), s


@dataclass
class Dropout:
    """Inverted dropout (torch nn.Dropout v2 semantics)."""

    rate: float

    def init(self, key):
        return {}, {}

    def apply(self, p, s, x, *, train=False, rng=None):
        if not train or self.rate <= 0.0:
            return x, s
        rngs = _as_rngs(rng)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(rngs.next(), keep, x.shape)
        return jnp.where(mask, x / keep, 0.0).astype(x.dtype), s


@dataclass
class Dense:
    """Linear layer. Torch-default uniform weight init, zero bias
    (reference zeroes Linear bias, `models/cifar/rnmg.lua:369-371`)."""

    c_in: int
    c_out: int
    dtype: Optional[Any] = None

    def init(self, key):
        s = 1.0 / math.sqrt(self.c_in)
        w = jax.random.uniform(key, (self.c_in, self.c_out), jnp.float32, -s, s)
        return {"w": w, "b": jnp.zeros((self.c_out,), jnp.float32)}, {}

    def apply(self, p, s, x, *, train=False, rng=None):
        w = cast_to(p["w"], self.dtype)
        x = cast_to(x, self.dtype)
        y = jnp.dot(x, w, preferred_element_type=jnp.float32)
        return y.astype(jnp.float32) + p["b"], s


@dataclass
class Sequential:
    """Composes layers; params/stats are dicts keyed '0','1',... ."""

    layers: list = field(default_factory=list)

    def init(self, key):
        params, stats = {}, {}
        keys = jax.random.split(key, max(len(self.layers), 1))
        for i, (layer, k) in enumerate(zip(self.layers, keys)):
            p, s = layer.init(k)
            params[str(i)] = p
            stats[str(i)] = s
        return params, stats

    def apply(self, p, s, x, *, train=False, rng=None):
        rng = _as_rngs(rng)
        new_s = {}
        for i, layer in enumerate(self.layers):
            x, new_s[str(i)] = layer.apply(
                p[str(i)], s[str(i)], x, train=train, rng=rng
            )
        return x, new_s


@dataclass
class ConvBN:
    """Conv -> BN [-> ReLU] [-> Dropout], the reference's basic unit
    (`models/cifar/nmg.lua:18-29`). Dropout placement is *after* ReLU in
    nmg but *before* conv in pnmg (`pnmg.lua:21-32`) — controlled by
    ``dropout_pos``."""

    c_in: int
    c_out: int
    k: int = 3
    stride: int = 1
    relu: bool = True
    eps: float = 1e-5
    dropout: float = 0.0
    dropout_pos: str = "after"  # "after" relu | "before" conv
    dtype: Optional[Any] = None

    def __post_init__(self):
        self.conv = Conv(self.c_in, self.c_out, self.k, self.stride, dtype=self.dtype)
        self.bn = BatchNorm(self.c_out, eps=self.eps)
        self.drop = Dropout(self.dropout) if self.dropout > 0 else None

    def init(self, key):
        kc, kb = jax.random.split(key)
        pc, _ = self.conv.init(kc)
        pb, sb = self.bn.init(kb)
        return {"conv": pc, "bn": pb}, {"bn": sb}

    def apply(self, p, s, x, *, train=False, rng=None):
        rng = _as_rngs(rng)
        if self.drop is not None and self.dropout_pos == "before":
            x, _ = self.drop.apply({}, {}, x, train=train, rng=rng)
        y, _ = self.conv.apply(p["conv"], {}, x, train=train)
        y, sb = self.bn.apply(p["bn"], s["bn"], y, train=train)
        if self.relu:
            y = jax.nn.relu(y)
        if self.drop is not None and self.dropout_pos == "after":
            y, _ = self.drop.apply({}, {}, y, train=train, rng=rng)
        return y, {"bn": sb}

    def apply_parts(self, p, s, parts, *, train=False, rng=None):
        """Fused-exchange path: convolve channel-concatenated exchange
        parts WITHOUT materializing the concat, by splitting the weight
        along its input-channel axis — conv(concat(xs), W) = sum_i
        conv(x_i, W_i). ``parts`` is a list of ``(kind, tensor)`` from
        ops.mg.exchange_parts; the "up" part arrives at COARSE
        resolution and its nearest-upsample is folded into the conv:

          k=3: conv3x3(up2(x), W) == dilated_conv(x, K, lhs_dilation=2,
               pad=2) with K[u,v] = sum_{a,b in {0,1}} W[u-a, v-b]
               (4x4 kernel, stride-2 transposed conv) — 4 taps per
               output pixel instead of 9 and no 2x-materialized tensor.
          k=1: conv1x1 at coarse res, then upsample the RESULT (4x
               fewer MACs).

        Numerically exact up to float summation order — EXCEPT under
        train-mode "before"-position dropout, where this path draws one
        mask per part while the materialized path draws one mask over
        the concat: the masks are iid Bernoulli either way
        (distributionally identical) but the PRNG streams differ, so
        fused/unfused training trajectories diverge stochastically.
        The "up" part is materialized first in that case so its mask is
        at fine resolution."""
        rng = _as_rngs(rng)
        from mgtpu.ops.mg import materialize_part  # cycle-free at call time
        from mgtpu.ops.resample import upsample_nearest2

        w = p["conv"]["w"]
        drop_live = self.drop is not None and self.dropout_pos == "before" and train
        oh = ow = None
        for kind, xp in parts:
            if kind != "up":
                oh, ow = xp.shape[1], xp.shape[2]
        y = None
        ofs = 0
        for kind, xp in parts:
            c = xp.shape[-1]
            ws = cast_to(w[:, :, ofs : ofs + c, :], self.dtype)
            ofs += c
            if kind == "up" and drop_live:
                xp = materialize_part(kind, xp, oh, ow)
                kind = "same"
            xp = cast_to(xp, self.dtype)
            if self.drop is not None and self.dropout_pos == "before":
                xp, _ = self.drop.apply({}, {}, xp, train=train, rng=rng)
            exact2x = kind == "up" and oh == 2 * xp.shape[1] and ow == 2 * xp.shape[2]
            if (exact2x and self.k == 3 and self.conv.stride == 1
                    and self.conv.pad == 1):
                yy = _conv_up3(xp, ws, oh, ow)
            elif (kind == "up" and self.k == 1 and self.conv.stride == 1
                    and self.conv.pad == 0):
                yy = jax.lax.conv_general_dilated(
                    xp, ws, (1, 1), [(0, 0), (0, 0)],
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                )
                yy = upsample_nearest2(yy, oh, ow)
            else:
                if kind == "up":
                    xp = materialize_part(kind, xp, oh, ow)
                yy = jax.lax.conv_general_dilated(
                    xp,
                    ws,
                    window_strides=(self.conv.stride, self.conv.stride),
                    padding=[(self.conv.pad, self.conv.pad)] * 2,
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                )
            y = yy if y is None else y + yy
        assert ofs == w.shape[2], (ofs, w.shape[2])
        if self.conv.bias:
            y = y + cast_to(p["conv"]["b"], y.dtype)
        y, sb = self.bn.apply(p["bn"], s["bn"], y, train=train)
        if self.relu:
            y = jax.nn.relu(y)
        if self.drop is not None and self.dropout_pos == "after":
            y, _ = self.drop.apply({}, {}, y, train=train, rng=rng)
        return y, {"bn": sb}


@dataclass
class UpConvBN:
    """FullConv 2x2/2 -> BN -> ReLU (`unmg.lua:35-40`)."""

    c_in: int
    c_out: int
    eps: float = 1e-3
    dtype: Optional[Any] = None

    def __post_init__(self):
        self.upconv = ConvTranspose(self.c_in, self.c_out, dtype=self.dtype)
        self.bn = BatchNorm(self.c_out, eps=self.eps)

    def init(self, key):
        kc, kb = jax.random.split(key)
        pc, _ = self.upconv.init(kc)
        pb, sb = self.bn.init(kb)
        return {"conv": pc, "bn": pb}, {"bn": sb}

    def apply(self, p, s, x, *, train=False, rng=None):
        y, _ = self.upconv.apply(p["conv"], {}, x, train=train)
        y, sb = self.bn.apply(p["bn"], s["bn"], y, train=train)
        return jax.nn.relu(y), {"bn": sb}


def _conv_up3(xp, ws, oh: int, ow: int):
    """conv3x3(nearest_up2(xp), ws, pad=1) as a stride-2 transposed
    (lhs-dilated) convolution with the 4x4 kernel
    K[u,v] = sum_{a,b in {0,1}} W[u-a, v-b]. Requires the exact-2x case
    (oh, ow) == (2h, 2w) — callers fall back to a materialized upsample
    for odd ceil-crops, whose bottom/right boundary taps differ.
    Exactness (values and grads) pinned in tests/test_fused_exchange.py."""
    assert (oh, ow) == (2 * xp.shape[1], 2 * xp.shape[2])
    ci, co = ws.shape[2], ws.shape[3]
    K = jnp.zeros((4, 4, ci, co), ws.dtype)
    for a in (0, 1):
        for b in (0, 1):
            K = K.at[a : a + 3, b : b + 3].add(ws)
    return jax.lax.conv_general_dilated(
        xp, K, (1, 1), [(2, 2), (2, 2)],
        lhs_dilation=(2, 2),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


def param_count(tree) -> int:
    return int(sum(np.prod(x.shape) for x in jax.tree.leaves(tree)))
