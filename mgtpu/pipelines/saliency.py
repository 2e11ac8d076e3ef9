"""Saliency pipeline — rebuild of `pipelines/saliency/{pipeline,test}.lua`.

For each test sample the loader expands 1 image into a 1+841 stack of
occluded variants (`dataset/mnist-saliency`); the whole stack forwards
in one batched jit call (the reference chunked into 8 to bound GPU
memory, `saliency/test.lua:132-138`; here the 842-stack is a single
vectorized forward). `interest_point` picks 7 probe regions (center + 6
bounding-box-edge points, `:51-117`); the saliency map accumulates
mask_i * max(|out_i - out_orig| * point_j) * 1(impact >= 0.1)
(`:146-157`); results go to testOutput.h5 groups
id%05d/{points,saliency,input,output} (`:163-168`).

The pipeline is just EPOCH=1; test() (`saliency/pipeline.lua:1-2`)."""

from __future__ import annotations

import math
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def interest_point(output: np.ndarray, th: float = 0.4, dp: int = 1) -> Optional[np.ndarray]:
    """output: (H, W, 1). Returns (7, H, W, 1) binary probe masks or
    None when the thresholded output has no extent."""
    assert output.ndim == 3 and output.shape[-1] == 1
    o = output[:, :, 0]
    h, w = o.shape
    col_max = o.max(axis=0) >= th  # per column
    row_max = o.max(axis=1) >= th  # per row
    if col_max.sum() < 2 or row_max.sum() < 2:
        return None
    cols = np.flatnonzero(col_max)
    rows = np.flatnonzero(row_max)
    col_st, col_ed = int(cols[0]), int(cols[-1])
    row_st, row_ed = int(rows[0]), int(rows[-1])

    def clamp(p, size):
        # keep the 2dp+1 window inside the image (`saliency/test.lua:90-94`)
        if p - dp < 0:
            p = dp
        if p + dp >= size:
            p = size - dp - 1
        return p

    points = np.zeros((7, h, w, 1), np.float32)
    x = clamp((col_st + col_ed) // 2, w)
    y = clamp((row_st + row_ed) // 2, h)
    points[0, y - dp : y + dp + 1, x - dp : x + dp + 1, 0] = 1
    k = 1
    for ix in range(2):
        x = clamp(col_st + ix * (col_ed - col_st), w)
        for iy in range(3):
            y = clamp(row_st + int(math.ceil((row_ed - row_st) * iy / 2)), h)
            points[k, y - dp : y + dp + 1, x - dp : x + dp + 1, 0] = 1
            k += 1
    return points


def saliency_map(outputs: np.ndarray, points: np.ndarray, mask: np.ndarray,
                 threshold: float = 0.1) -> np.ndarray:
    """outputs: (1+N, H, W, C); points: (7, H, W, 1); mask: (N, H, W, 1).
    Vectorized version of the reference's accumulation loop."""
    ori = outputs[0]
    diff = np.abs(outputs[1:] - ori[None])  # (N, H, W, C)
    n = diff.shape[0]
    p = points.shape[0]
    # (N, P): max over pixels/channels of diff * point mask. Probe masks
    # are tiny (2dp+1)^2 boxes, so slice each mask's bounding box
    # instead of broadcasting an (N, P, H*W, C) product (~92 MB/sample
    # at N=841): identical result — diff >= 0 and the mask is 0 outside
    # the box, so the masked max over the box equals the full-grid max.
    impact = np.zeros((n, p), np.float32)
    for j in range(p):
        ys, xs = np.nonzero(points[j, :, :, 0])
        if ys.size == 0:
            continue
        sub = (diff[:, ys.min():ys.max() + 1, xs.min():xs.max() + 1]
               * points[j, ys.min():ys.max() + 1, xs.min():xs.max() + 1])
        impact[:, j] = sub.reshape(n, -1).max(1)
    keep = (impact >= threshold).astype(np.float32) * impact  # (N, P)
    sal = np.einsum("np,nhwk->phwk", keep, mask)
    return sal.astype(np.float32)


def _interest_point_jnp(output, th: float = 0.4, dp: int = 1):
    """Device-side interest_point: output (H, W, C>=1) -> (valid scalar,
    (7, H, W, 1) probe masks). Identical probe layout to the host
    version (verified bit-exact in tests/test_saliency.py); `valid`
    replaces the host path's None return."""
    o = output[:, :, 0].astype(jnp.float32)
    h, w = o.shape
    col_ok = jnp.max(o, axis=0) >= th
    row_ok = jnp.max(o, axis=1) >= th
    valid = (jnp.sum(col_ok) >= 2) & (jnp.sum(row_ok) >= 2)
    col_st = jnp.argmax(col_ok)
    col_ed = w - 1 - jnp.argmax(col_ok[::-1])
    row_st = jnp.argmax(row_ok)
    row_ed = h - 1 - jnp.argmax(row_ok[::-1])

    def clamp(p, size):
        p = jnp.where(p - dp < 0, dp, p)
        return jnp.where(p + dp >= size, size - dp - 1, p)

    pts = [(clamp((row_st + row_ed) // 2, h), clamp((col_st + col_ed) // 2, w))]
    for ix in range(2):
        x = clamp(col_st + ix * (col_ed - col_st), w)
        for iy in range(3):
            y = clamp(
                row_st + jnp.ceil((row_ed - row_st) * iy / 2.0).astype(row_st.dtype),
                h,
            )
            pts.append((y, x))
    ii = jnp.arange(h)[:, None]
    jj = jnp.arange(w)[None, :]
    points = jnp.stack(
        [
            ((jnp.abs(ii - y) <= dp) & (jnp.abs(jj - x) <= dp)).astype(jnp.float32)
            for y, x in pts
        ]
    )[..., None]
    return valid, points


def _saliency_map_jnp(outputs, points, mask, threshold: float = 0.1):
    """Device-side saliency_map. The host version's bounding-box slice
    is a host-loop optimization; on device the full masked max fuses
    into one reduction (same result: diff >= 0, mask 0 elsewhere)."""
    ori = outputs[0]
    diff = jnp.abs(outputs[1:] - ori[None]).astype(jnp.float32)  # (N,H,W,C)
    impact = jnp.max(diff[:, None] * points[None], axis=(2, 3, 4))  # (N,P)
    keep = jnp.where(impact >= threshold, impact, 0.0)
    return jnp.einsum("np,nhwk->phwk", keep, mask)


def run(sess) -> None:
    import time

    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "the saliency pipeline writes testOutput.h5, which needs h5py "
            "(not installed)"
        ) from e

    opt = sess.opt
    loader = sess.loaders["test"]
    n_test = loader.size()
    mask = loader.mask  # (841, H, W, 1)
    # -saliencyDumpStack 1 (default) keeps the reference's full h5
    # layout incl. the (842, H, W, C) output stack per sample
    # (`saliency/test.lua:163-168`), paying a ~14 MB/sample transfer.
    # 0 computes probe points + saliency ON DEVICE and transfers only
    # {points, saliency} (~100 KB/sample) — the algorithm itself never
    # needed the stack on the host (VERDICT r2 #3).
    dump_stack = bool(int(getattr(opt, "saliencyDumpStack", 1)))

    # Group k samples' 1+841 stacks into ONE jit call (a reshape to
    # (k*842, H, W, 1) — per-sample eval-mode forwards are independent,
    # so grouping is bit-identical) and double-buffer: the next group's
    # forward is dispatched before this group's host-side probe/h5 work,
    # overlapping device compute with host writes. The reference instead
    # chunked each stack into 8 to bound GPU memory
    # (`saliency/test.lua:132-138`).
    k = max(int(getattr(opt, "saliencyBatch", 4)), 1)
    k = min(k, max(n_test, 1))
    fwd = jax.jit(lambda p, s, x: sess.model.apply(p, s, x, train=False)[0])
    n_stack = 1 + mask.shape[0]

    def _probe_one(o, m):
        """Shared device-side probe for one sample's (1+N, ...) output
        stack — the single implementation behind both -saliencyDumpStack
        0 variants below."""
        valid, points = _interest_point_jnp(o[0])
        sal = _saliency_map_jnp(o, points, m)
        return valid, points, sal

    # Fallback device-probe path for loaders WITHOUT device-side stack
    # expansion (a plugin saliency dataset whose hook host-expands the
    # stack still gets on-device probe/impact); the shipped
    # mnist-saliency loader always takes the expand_dev path below.
    def _fwd_probe_impl(p, s, flat, m):
        out = sess.model.apply(p, s, flat, train=False)[0]
        outs = out.reshape((k, n_stack) + out.shape[1:])
        return jax.vmap(lambda o: _probe_one(o, m))(outs)

    fwd_probe = jax.jit(_fwd_probe_impl)

    # With a device-expanding loader (-saliencyDumpStack 0 builds the
    # loader in raw mode), the 1+841 stack is constructed ON DEVICE
    # from the ~16 KB base image: variant i = (1-mask_i)*img + noise_i,
    # then the meanstd normalize — the same deterministic elementwise
    # chain the host hook runs (`tf.occlusion` + `tf.color_normalize`),
    # so nothing but the base image crosses the host-device link.
    expand_dev = (not dump_stack) and getattr(loader, "expand", "host") == "device"
    if expand_dev:
        # the loader hands back the host-NORMALIZED base image b (so the
        # h5 'input' stays bit-identical to the parity path); the
        # normalized occluded variant is the affine map
        #   ((1-m)*img + noise - mean)/std = (1-m)*b + (noise - m*mean)/std
        # whose constant second term is precomputed once here
        mean = np.asarray(loader.meanstd[0], np.float32)
        std = np.asarray(loader.meanstd[1], np.float32)
        offset_dev = jnp.asarray((loader.noise - mask * mean) / std)

        def _fwd_probe_base_impl(p, s, base, m, offset):
            inv = 1.0 - m

            def expand(b):  # (H, W, C) normalized -> (842, H, W, C)
                return jnp.concatenate([b[None], inv * b[None] + offset], 0)

            stacks = jax.vmap(expand)(base)  # (k, 842, H, W, C)
            flat = stacks.reshape((-1,) + stacks.shape[2:])
            out = sess.model.apply(p, s, flat, train=False)[0]
            outs = out.reshape((k, n_stack) + out.shape[1:])
            valid, pts, sal = jax.vmap(lambda o: _probe_one(o, m))(outs)
            return valid, pts, sal, stacks[:, 0]

        fwd_probe_base = jax.jit(_fwd_probe_base_impl)
    mask_dev = None if dump_stack else jnp.asarray(mask)
    # shard the k*842 stack over the data mesh when it divides (842 is
    # even, so k*842 divides any power-of-two mesh for even k); params
    # are already replicated by the Session — without this the forward
    # would run fully replicated on every chip
    mesh = getattr(sess, "mesh", None)  # None under the test harness
    n_data = mesh.shape["data"] if mesh is not None else 1
    # (on a 1-device mesh the explicit device_put costs ~20% measured
    # vs the async jnp.asarray path, for nothing — shard only when >1)
    n_rows = k if expand_dev else k * (1 + mask.shape[0])
    shardable = n_data > 1 and n_rows % n_data == 0

    path = os.path.join(opt.save, "testOutput.h5")
    os.makedirs(opt.save, exist_ok=True)
    print("==> doing epoch on testing data:")
    print("==> online epoch # 1")

    def specs():
        for i in range(1, n_test + 1):
            yield ("get", "test", i, i, 1)

    import time as _time

    _timing = bool(os.environ.get("MGTPU_SALIENCY_TIMING"))

    def dispatch(items):
        """items: list of (ind, stack-or-raw-image), padded to k so the
        jit sees one static shape. Returns without blocking."""
        _t0 = _time.time()
        n_valid = len(items)
        items = items + [items[-1]] * (k - n_valid)
        # host-expanded: (k, 842, H, W, 1); device-expanded: (k, H, W, 1)
        stacks = np.stack([s for _, s in items])
        arr = stacks if expand_dev else stacks.reshape((-1,) + stacks.shape[2:])
        if shardable:
            # batch-only sharding, even under -spatial: the 842-stack is
            # purely data-parallel and params are replicated, while the
            # H-split path would have to check height divisibility and
            # the >=8-rows heuristic for nothing
            from mgtpu.parallel.mesh import shard_batch

            arr = shard_batch(mesh, {"x": arr}, spatial=False)["x"]
        else:
            arr = jnp.asarray(arr)

        def call():
            if dump_stack:
                return fwd(sess.params, sess.stats, arr)
            if expand_dev:
                return fwd_probe_base(sess.params, sess.stats, arr,
                                      mask_dev, offset_dev)
            return fwd_probe(sess.params, sess.stats, arr, mask_dev)

        if mesh is not None:
            with jax.set_mesh(mesh):
                out = call()
        else:
            out = call()
        # keep only each sample's un-occluded input for the h5 dump —
        # retaining the full (k, 842, H, W, 1) host stack would hold
        # ~55 MB per double-buffered group for a 65 KB need (the
        # device-expanded path returns it from the jit instead)
        inputs0 = None if expand_dev else stacks[:, 0].copy()
        if _timing:
            print(f"[timing] dispatch {_time.time() - _t0:.3f}s", flush=True)
        return [i for i, _ in items[:n_valid]], inputs0, out, n_valid

    def groups():
        buf = []
        for ind, (x, _y) in zip(range(1, n_test + 1),
                                sess.pool.imap_specs(specs())):
            buf.append((ind, x[0]))
            if len(buf) == k:
                yield dispatch(buf)
                buf = []
        if buf:
            yield dispatch(buf)

    t0 = time.time()
    with h5py.File(path, "w") as f:

        def consume(group):
            _t0 = _time.time()
            inds, inputs0, out, n_valid = group
            if dump_stack:  # parity path: host probe from the full stack
                out_np = np.asarray(out)  # (k*842, Ho, Wo, Co)
                outs = out_np.reshape((k, -1) + out_np.shape[1:])
                for j, ind in enumerate(inds):
                    outputs = outs[j]
                    points = interest_point(outputs[0])
                    if points is None:  # no confident output extent
                        continue
                    sal = saliency_map(outputs, points, mask)
                    gid = f"id{ind:05d}"
                    print(gid)
                    f.create_dataset(f"{gid}/points", data=points)
                    f.create_dataset(f"{gid}/saliency", data=sal)
                    f.create_dataset(f"{gid}/input", data=inputs0[j])
                    f.create_dataset(f"{gid}/output", data=outputs)
                return
            if expand_dev:  # normalized base image comes from the jit
                valid, points_k, sal_k, inputs0 = (np.asarray(x) for x in out)
            else:
                valid, points_k, sal_k = (np.asarray(x) for x in out)
            if _timing:
                print(f"[timing] consume-fetch {_time.time() - _t0:.3f}s",
                      flush=True)
            for j, ind in enumerate(inds):
                if not valid[j]:
                    continue
                gid = f"id{ind:05d}"
                print(gid)
                f.create_dataset(f"{gid}/points", data=points_k[j])
                f.create_dataset(f"{gid}/saliency", data=sal_k[j])
                f.create_dataset(f"{gid}/input", data=inputs0[j])

        pending = None
        for group in groups():  # dispatch g+1 before consuming g
            if pending is not None:
                consume(pending)
            pending = group
        if pending is not None:
            consume(pending)
    dt = time.time() - t0
    print(f"saliency: {n_test} samples in {dt:.2f}s "
          f"({n_test / max(dt, 1e-9):.2f} samples/s, group size {k})")
    print(f"saliency maps -> {path}")
