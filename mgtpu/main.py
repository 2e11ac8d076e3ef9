"""Entry point — rebuild of `main.lua` + `run.lua`:

    python -m mgtpu.main -netType cifar/nmg -dataset cifar100-whitened \
        -data synthetic -nLayer 2 -train -test ...

Boot order mirrors `main.lua:36-58`: parse opts (two-stage), seed, make
the save dir, build the session (model/mesh/data/steps — replacing the
multigpu.lua + model.lua + data.lua globals), then dispatch to the
selected pipeline (`run.lua:1-33`)."""

from __future__ import annotations

import json
import os
import random

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Where XLA's persistent compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.
    The default is fixed, independent of the working directory and of
    ``-cache``, so every run and resume of this checkout shares one
    cache (R-MG-34 has many distinct conv shapes, each autotuned on
    first compile)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache")


def init_compile_cache() -> str:
    """Point JAX at :func:`compile_cache_dir` before the first compile.
    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set
    nothing is overridden here. Returns the directory in use."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def main(argv=None):
    """Run the CLI; returns the finished Session (its params, stats and
    jitted steps), so an in-process caller can inspect the run."""
    from mgtpu.utils.opts import parse

    opt = parse(argv)

    if getattr(opt, "multihost", False):
        # must run before any other jax call initializes the backend
        from mgtpu.parallel.mesh import init_multihost

        init_multihost()

        # Every process computed its own microsecond-stamped run dir in
        # parse(), so they'd never agree on a shared filesystem — adopt
        # process 0's dir everywhere (broadcast across processes), then give
        # non-primary processes a procN/ subdir under it so their
        # opts.json/logs don't interleave with the primary's;
        # checkpoints/h5 additionally stay primary-only (standard.py
        # gates on is_primary).
        import jax
        from jax.experimental import multihost_utils

        raw = opt.save.encode("utf-8")
        if len(raw) > 1024:
            raise SystemExit(
                f"-cache run dir is {len(raw)} bytes encoded; the multihost "
                "broadcast buffer is 1024 — use a shorter -cache path"
            )
        raw = raw.ljust(1024, b"\0")
        buf = multihost_utils.broadcast_one_to_all(
            np.frombuffer(raw, np.uint8).copy()
        )
        opt.save = bytes(np.asarray(buf)).rstrip(b"\0").decode("utf-8")
        if jax.process_index() != 0:
            opt.save = os.path.join(opt.save, f"proc{jax.process_index()}")

    random.seed(opt.manualSeed)
    np.random.seed(opt.manualSeed)

    os.makedirs(opt.save, exist_ok=True)
    with open(os.path.join(opt.save, "opts.json"), "w") as f:
        json.dump({k: v for k, v in vars(opt).items() if k != "compute_dtype"},
                  f, indent=2, default=str)
    print(f"==> run dir: {opt.save}")

    init_compile_cache()

    from mgtpu.pipelines.standard import Session

    sess = Session(opt)

    # shutdown in finally: an exception mid-run must not leave process-
    # mode donkey workers alive
    try:
        if opt.pipeline == "saliency":
            from mgtpu.pipelines import saliency

            sess.epoch = 1
            saliency.run(sess)
        else:
            from mgtpu.pipelines import standard

            standard.run(sess)
    finally:
        from mgtpu.utils.checkpoint import join_pending_saves

        try:
            # don't exit under an in-flight ckpt write; re-raises a
            # background write failure (ENOSPC, ...)
            join_pending_saves()
        finally:
            # ...but a failed write must not skip the donkey-pool
            # teardown (process workers would be left to interpreter
            # exit and can wedge it)
            sess.pool.shutdown()
    return sess


if __name__ == "__main__":
    main()
