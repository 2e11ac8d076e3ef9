"""Checkpoint save/load.

Rebuild of the reference's `saveDataParallel`/`loadDataParallel`
(`multigpu.lua:105-160`) with intentional upgrades (SURVEY §5):
  - optimizer (momentum) state IS checkpointed (the reference rebuilt
    optimState each epoch);
  - checkpoints are host/device-layout agnostic pytrees — no DPT
    stripping/re-expansion needed;
  - the format is a versioned npz archive (zip of raw .npy arrays plus
    a JSON structure record), NOT a pickle: loading never executes
    code and survives class/module refactors. The reference's .t7
    blobs (and round 1's pickle) had both flaws.

Like torch's whole-model blobs, a checkpoint carries enough metadata
(netType + model flags) to rebuild the architecture, which the
mnist-test/mnist-saliency harness models rely on
(`models/mnist-cluttered/mnist-saliency.lua:7-15`)."""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional

import jax
import numpy as np

import ml_dtypes

CKPT_FORMAT = "mgtpu-ckpt"
CKPT_VERSION = 1

# numpy can't round-trip these through npz headers portably; store the
# raw bits in a same-width standard dtype and record the real one.
_VIEW_DTYPES = {
    "bfloat16": (ml_dtypes.bfloat16, np.uint16),
    "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, np.uint8),
    "float8_e5m2": (ml_dtypes.float8_e5m2, np.uint8),
}


def _encode(tree, arrays: list):
    """Pytree -> JSON-able structure with array leaves swapped for
    indices into `arrays`. Supports dict/list/tuple/None containers —
    everything the model framework produces (nested dicts today)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        for k in tree:
            # keys round-trip as strings; a non-str key would save fine
            # but load as a DIFFERENT tree (silent structure corruption).
            # A real raise, not assert: -O must not strip this guard.
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be str, got {k!r}")
        return {"t": "d", "k": {k: _encode(v, arrays) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {
            "t": "l" if isinstance(tree, list) else "u",
            "c": [_encode(v, arrays) for v in tree],
        }
    x = np.asarray(tree)
    entry: Dict[str, Any] = {"t": "a", "i": len(arrays)}
    for name, (real, view) in _VIEW_DTYPES.items():
        if x.dtype == real:
            entry["dtype"] = name
            x = x.view(view)
            break
    arrays.append(x)
    return entry


def _decode(node, arrays):
    if node is None:
        return None
    t = node["t"]
    if t == "d":
        return {k: _decode(v, arrays) for k, v in node["k"].items()}
    if t == "l":
        return [_decode(v, arrays) for v in node["c"]]
    if t == "u":
        return tuple(_decode(v, arrays) for v in node["c"])
    x = arrays[node["i"]]
    if "dtype" in node:
        x = x.view(_VIEW_DTYPES[node["dtype"]][0])
    return x


def _to_host(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


# -- async write plumbing -------------------------------------------------
# One pending writer thread at most: a new save (or any load) joins the
# previous one first, and mgtpu.main joins in its `finally`, so a crash
# mid-run leaves at worst an orphaned `.tmp` — never a torn checkpoint
# (the visible file only ever appears via os.replace).
import threading

_pending_save: Optional[threading.Thread] = None
_pending_error: Optional[BaseException] = None


def pending_save_failed() -> bool:
    """Join any in-flight async write and report (without clearing or
    raising) whether it failed. Lets the -multihost save path broadcast
    the failure so ALL processes abort together instead of the peers
    hanging in the next collective until the distributed timeout."""
    global _pending_save
    if _pending_save is not None:
        _pending_save.join()
        _pending_save = None
    return _pending_error is not None


def join_pending_saves() -> None:
    """Block until any in-flight async checkpoint write has completed.
    Re-raises a background write failure (ENOSPC, permissions, ...) —
    otherwise the run would print 'checkpoint -> path' and exit 0 with
    no checkpoint on disk."""
    global _pending_save, _pending_error
    if _pending_save is not None:
        _pending_save.join()
        _pending_save = None
    if _pending_error is not None:
        err, _pending_error = _pending_error, None
        raise RuntimeError("async checkpoint write failed") from err


def _write_npz(path: str, struct_json: str, arrays: list) -> None:
    tmp = path + ".tmp"
    # savez on a file OBJECT so numpy does not append ".npz" to our name
    with open(tmp, "wb") as f:
        np.savez(f, __struct__=struct_json,
                 **{f"a{i}": x for i, x in enumerate(arrays)})
    os.replace(tmp, path)


def _write_npz_bg(path: str, struct_json: str, arrays: list) -> None:
    global _pending_error
    try:
        _write_npz(path, struct_json, arrays)
    except BaseException as e:  # surfaced by the next join_pending_saves
        _pending_error = e


def save_checkpoint(path: str, params, stats, opt_state=None, epoch: int = 0,
                    meta: Optional[Dict[str, Any]] = None,
                    async_write: bool = False):
    """Write a checkpoint. With ``async_write`` the device->host fetch
    still happens HERE (it must: the session's donated train step will
    invalidate these buffers on its next dispatch) but the npz
    serialization + disk write move to a background thread, so training
    resumes while the bytes land. At most one write is in flight."""
    global _pending_save
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: list = []
    struct = {
        "format": CKPT_FORMAT,
        "version": CKPT_VERSION,
        "epoch": int(epoch),
        "meta": meta or {},
        "params": _encode(_to_host(params), arrays),
        "stats": _encode(_to_host(stats), arrays),
        "opt_state": _encode(_to_host(opt_state), arrays)
        if opt_state is not None
        else None,
    }
    sjson = json.dumps(struct)
    if not async_write:
        _write_npz(path, sjson, arrays)
        return
    join_pending_saves()
    t = threading.Thread(
        target=_write_npz_bg, args=(path, sjson, arrays),
        name="mgtpu-ckpt-writer", daemon=True,
    )
    t.start()
    _pending_save = t


def _load_pickle_legacy(path: str) -> Dict[str, Any]:
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def load_checkpoint(path: str, allow_pickle: bool = False) -> Dict[str, Any]:
    """Load a checkpoint. Never unpickles unless `allow_pickle=True`
    (CLI: -allowPickleCkpt), which migrates round-1 pickle blobs."""
    join_pending_saves()  # a just-dispatched async save must be visible
    if not zipfile.is_zipfile(path):
        if not allow_pickle:
            raise ValueError(
                f"{path} is not an mgtpu-ckpt npz archive. If it is a "
                "legacy pickle checkpoint, re-run with -allowPickleCkpt "
                "to migrate it (unpickling executes arbitrary code — "
                "only do this for files you trust)."
            )
        print(f"WARNING: loading legacy pickle checkpoint {path}")
        return _load_pickle_legacy(path)
    with np.load(path, allow_pickle=False) as z:
        struct = json.loads(str(z["__struct__"]))
        if struct.get("format") != CKPT_FORMAT:
            raise ValueError(f"{path}: unknown checkpoint format {struct.get('format')!r}")
        if struct["version"] > CKPT_VERSION:
            raise ValueError(
                f"{path}: checkpoint version {struct['version']} is newer "
                f"than this code understands ({CKPT_VERSION})"
            )
        arrays = [z[f"a{i}"] for i in range(sum(1 for k in z.files if k != "__struct__"))]
    return {
        "params": _decode(struct["params"], arrays),
        "stats": _decode(struct["stats"], arrays),
        "opt_state": _decode(struct["opt_state"], arrays),
        "epoch": struct["epoch"],
        "meta": struct["meta"],
    }


def model_meta(opt) -> Dict[str, Any]:
    """Flags a checkpoint needs to rebuild its architecture."""
    keys = ("netType", "dataset", "nLayer", "isDropout", "depth",
            "shortcutType", "dtype")
    return {k: getattr(opt, k) for k in keys if hasattr(opt, k)}
