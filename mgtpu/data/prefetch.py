"""Donkey pool — async host-side batch production.

Rebuild of the reference's thread pool (`data.lua:15-38`), with the
reference's REAL concurrency model available: each Torch donkey was a
separate Lua state running its own `donkey.lua` with its own loader
instances. The Python translation of that is a *process* pool whose
workers each build their own loaders from `opt` (``mode="process"``,
`-donkeyMode process`) — immune to the GIL for decode-heavy datasets
(ilsvrc). The default ``mode="thread"`` shares loaders and suits
blob-backed datasets whose per-sample work is numpy/native C (GIL
released). Measure on YOUR host with tools/bench_data.py — the dev box
for this repo has a single CPU core, where any pool necessarily
measures slower than in-process.

``n_donkeys=0`` degrades to a synchronous in-process pool for
debugging (`data.lua:32-37`). Determinism: every job carries its own
integer seed derived from (manualSeed, epoch, iteration), so results
are identical for ANY pool size or mode — stronger than the
reference, whose batch order was donkey-completion-dependent.

Jobs are declarative specs (module-level, picklable):
  ("gen", split, batch_size, epoch, seed, iter_size)  -> training batch
  ("get", split, i1, i2, epoch)                       -> eval slice
Thread/sync pools also accept plain callables via ``imap``.
"""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np

# --- worker-side execution (module-level so process workers can run it) ---

_WORKER_LOADERS = None
_WORKER_OPT = None


def _init_worker(opt_state: dict):
    """Process-pool initializer: rebuild the loaders in this worker,
    exactly like each reference donkey dofile'ing donkey.lua. A worker
    only makes host arrays, and must never open the accelerator: a JAX
    process reserves most of a GPU's memory when it first touches it,
    which would starve the training process."""
    global _WORKER_LOADERS, _WORKER_OPT
    import os
    import types

    os.environ["JAX_PLATFORMS"] = "cpu"

    _WORKER_OPT = types.SimpleNamespace(**opt_state)
    _WORKER_LOADERS = None  # built lazily on first job


def _exec_spec(loaders, spec):
    kind = spec[0]
    if kind == "gen":
        _, split, batch_size, epoch, seed, iter_size = spec
        loader = loaders[split]
        if iter_size == 1:
            x, y = loader.gen_inputs(batch_size, epoch, seed)
            return {"x": x, "y": y}
        micro = [
            loader.gen_inputs(batch_size, epoch, seed + j)
            for j in range(iter_size)
        ]
        return {
            "x": np.stack([m[0] for m in micro]),
            "y": np.stack([m[1] for m in micro]),
        }
    if kind == "get":
        _, split, i1, i2, epoch = spec
        return loaders[split].get_inputs(i1, i2, epoch)
    raise ValueError(f"unknown job spec {spec!r}")


def _proc_run(spec):
    global _WORKER_LOADERS
    if _WORKER_LOADERS is None:
        from mgtpu.data import get_loaders

        _WORKER_LOADERS = get_loaders(_WORKER_OPT)
    return _exec_spec(_WORKER_LOADERS, spec)


def _picklable_opt_state(opt) -> dict:
    import pickle

    state = {}
    dropped = []
    for k, v in vars(opt).items():
        try:
            pickle.dumps(v)
        except Exception:
            dropped.append(k)
            continue
        state[k] = v
    if dropped:
        print(
            f"WARNING: -donkeyMode process drops unpicklable opt attrs "
            f"{dropped}; workers rebuild loaders without them"
        )
    return state


class DonkeyPool:
    """Ordered prefetching pool over job specs or callables.

    mode: "thread" (default) | "process". Process mode needs ``opt``
    (and ``loaders`` built from it in the parent are NOT shared —
    workers rebuild their own). A pool with n_donkeys=0 is synchronous
    regardless of mode.
    """

    def __init__(self, n_donkeys: int = 2, mode: str = "thread",
                 opt=None, loaders=None):
        self.n = n_donkeys
        self.mode = mode if n_donkeys > 0 else "sync"
        self.loaders = loaders
        self._pool = None
        if n_donkeys > 0:
            if mode == "process":
                assert opt is not None, "process mode needs opt"
                import multiprocessing as mp

                self._pool = ProcessPoolExecutor(
                    max_workers=n_donkeys,
                    mp_context=mp.get_context("spawn"),
                    initializer=_init_worker,
                    initargs=(_picklable_opt_state(opt),),
                )
            else:
                self._pool = ThreadPoolExecutor(max_workers=n_donkeys)

    # --- spec interface (works in every mode) ---

    def imap_specs(self, specs: Iterable[tuple]) -> Iterator[object]:
        if self._pool is None:
            for spec in specs:
                yield _exec_spec(self.loaders, spec)
            return
        if self.mode == "process":
            submit = lambda spec: self._pool.submit(_proc_run, spec)
        else:
            submit = lambda spec: self._pool.submit(_exec_spec, self.loaders, spec)
        yield from self._ordered(map(submit, iter(specs)))

    # --- callable interface (thread/sync only; kept for tools/tests) ---

    def imap(self, jobs: Iterable[Callable[[], object]]) -> Iterator[object]:
        if self._pool is None:
            for job in jobs:
                yield job()
            return
        assert self.mode == "thread", "callable jobs require thread mode"
        yield from self._ordered(self._pool.submit(job) for job in jobs)

    def _ordered(self, futures: Iterator) -> Iterator[object]:
        """Drain futures preserving order with a lookahead of n+1."""
        pending = []
        it = iter(futures)
        try:
            for _ in range(self.n + 1):
                pending.append(next(it))
        except StopIteration:
            pass
        while pending:
            fut = pending.pop(0)
            try:
                pending.append(next(it))
            except StopIteration:
                pass
            yield fut.result()

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
