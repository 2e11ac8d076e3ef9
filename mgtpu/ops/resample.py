"""Spatial resampling primitives on NHWC arrays.

JAX equivalents of the Torch pooling/upsampling modules the
reference composes for cross-scale exchange:
  - `nn.SpatialMaxPooling(2,2,2,2):ceil()`  -> maxpool2_ceil
  - `cudnn.SpatialAveragePooling(r,r,r,r)`  -> avgpool
  - `nn.SpatialUpSamplingNearest(2)`        -> upsample_nearest2
(reference: /root/reference/models/cifar/nmg.lua:13-16,56,72,99).

All are expressed via lax.reduce_window / jnp.repeat so XLA fuses them
into neighboring convolutions; no gather/scatter, static shapes only.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _ceil_pad(size: int, k: int, s: int) -> int:
    """Right-padding that emulates Torch ceil-mode pooling output
    ceil((size - k)/s) + 1."""
    out = -(-(size - k) // s) + 1
    return max(0, (out - 1) * s + k - size)


def maxpool2_ceil(x: jax.Array) -> jax.Array:
    """2x2/2 max pool with ceil semantics (pads right/bottom with -inf).

    reduce_window forward, select_and_scatter backward: both are plain
    XLA ops that the GPU backend fuses and schedules itself. Other
    formulations (strided-phase slicing, a mask-based custom VJP) are
    unmeasured on the GPU."""
    ph = _ceil_pad(x.shape[1], 2, 2)
    pw = _ceil_pad(x.shape[2], 2, 2)
    return jax.lax.reduce_window(
        x,
        -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(x.dtype).min,
        jax.lax.max,
        window_dimensions=(1, 2, 2, 1),
        window_strides=(1, 2, 2, 1),
        padding=((0, 0), (0, ph), (0, pw), (0, 0)),
    )


def maxpool(x: jax.Array, k: int, s: int, pad: int = 0) -> jax.Array:
    """General max pool, floor semantics (Torch default), e.g. the 3x3/2
    pad-1 pool in the ImageNet stem (`models/ilsvrc/rnmg.lua:183`)."""
    init = -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(x.dtype).min
    return jax.lax.reduce_window(
        x,
        init,
        jax.lax.max,
        window_dimensions=(1, k, k, 1),
        window_strides=(1, s, s, 1),
        padding=((0, 0), (pad, pad), (pad, pad), (0, 0)),
    )


def avgpool(x: jax.Array, r: int, s: int | None = None) -> jax.Array:
    """r x r / s average pool, VALID (used for the input pyramid where
    sizes divide exactly, and the 7x7 classifier pool). Reshape-based
    fast paths avoid reduce_window where possible."""
    s = r if s is None else s
    n, h, w, c = x.shape
    if r == h and r == w:  # global (e.g. Avg(7,7) on 7x7)
        return jnp.mean(x.astype(jnp.float32), axis=(1, 2), keepdims=True).astype(x.dtype)
    if s == r and h % r == 0 and w % r == 0:
        y = x.astype(jnp.float32).reshape(n, h // r, r, w // r, r, c).mean(axis=(2, 4))
        return y.astype(x.dtype)
    y = jax.lax.reduce_window(
        x.astype(jnp.float32),
        0.0,
        jax.lax.add,
        window_dimensions=(1, r, r, 1),
        window_strides=(1, s, s, 1),
        padding="VALID",
    )
    return (y / (r * r)).astype(x.dtype)


def global_avgpool(x: jax.Array) -> jax.Array:
    """Mean over H,W -> (N, C)."""
    return jnp.mean(x, axis=(1, 2))


def upsample_nearest2(x: jax.Array, out_h: int | None = None, out_w: int | None = None) -> jax.Array:
    """Nearest-neighbor 2x upsample; optionally crops to (out_h, out_w)
    so odd-sized ceil-pooled partners concat cleanly."""
    y = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    if out_h is not None and y.shape[1] != out_h:
        y = y[:, :out_h]
    if out_w is not None and y.shape[2] != out_w:
        y = y[:, :, :out_w]
    return y


def ceil_div2(n: int) -> int:
    return -(-n // 2)
