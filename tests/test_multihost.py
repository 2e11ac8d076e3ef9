"""Multi-host (-multihost) CLI path: two coordinated CPU processes run
the FULL training CLI over one global mesh (the multi-process extension of
SURVEY §2.6 — the reference stopped at single-host,
`multigpu.lua:85`). Pins:
  - identical train/test metrics on every process (SPMD consistency),
  - checkpoint written by process 0 ONLY (params are replicated, so
    one copy is canonical),
  - process 1's artifacts redirected to a proc1/ subdir (no shared-fs
    collisions),
  - the eval loop's cross-process output gather (fetch_global) feeding
    the ragged-tail recompute AND the mnist-test stored-output h5 dump
    with the full global split (the reference's train -> mnist-test
    -retrain flow, `mnist-test.lua:19-36`).
"""

import glob
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two_process(args, timeout=560, devices_per_proc=2):
    """Launch the CLI twice (process 0/1) on one global CPU mesh of
    2 * devices_per_proc devices."""
    port = _free_port()
    base_env = dict(
        os.environ,
        PYTHONPATH=REPO,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={devices_per_proc}",
        MGTPU_COORDINATOR=f"127.0.0.1:{port}",
        MGTPU_NUM_PROCESSES="2",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mgtpu.main"] + args,
            env=dict(base_env, MGTPU_PROCESS_ID=str(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, (out[-1500:], err[-1500:])
    return outs


@pytest.mark.slow
def test_two_process_cli_train_then_mnist_test(tmp_path):
    # ---- phase 1: train + test (synthSize 40 -> test split of 10,
    # batch 8 -> ragged tail of 2 exercises fetch_global on the
    # pad-recompute path) ----
    common = [
        "-dataset", "mnist-seg", "-data", "synthetic", "-synthSize", "40",
        "-batchSize", "8", "-nGPU", "4", "-nDonkeys", "0", "-multihost",
        "-cache", str(tmp_path),
    ]
    outs = _run_two_process(
        ["-netType", "mnist-cluttered/unmg", "-nEpochs", "1",
         "-epochSize", "2", "-train", "-test"] + common,
    )

    # SPMD consistency: both processes report the same averages
    losses = []
    for _, out, _ in outs:
        m = re.search(r"\[TESTING\].*avg\.loss:([0-9.]+)", out)
        assert m, out[-800:]
        losses.append(float(m.group(1)))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)

    # ...and the 2-process run computes the SAME numbers as one process
    # over the same 4-device global mesh (multihost is pure layout, not
    # different math): identical seeds/batches -> identical test loss
    env = dict(
        os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    single_args = [a for a in common if a != "-multihost"]
    # the comparison run's artifacts must live OUTSIDE tmp_path: the
    # primary-only assertions below glob tmp_path recursively, and the
    # single run writes its own model_1.ckpt / testOutput_1.h5 too
    single_args[single_args.index("-cache") + 1] = str(tmp_path) + "_single"
    r = subprocess.run(
        [sys.executable, "-m", "mgtpu.main", "-netType",
         "mnist-cluttered/unmg", "-nEpochs", "1", "-epochSize", "2",
         "-train", "-test"] + single_args,
        env=env, capture_output=True, text=True, cwd=REPO, timeout=560,
    )
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    m = re.search(r"\[TESTING\].*avg\.loss:([0-9.]+)", r.stdout)
    assert m, r.stdout[-800:]
    # loss is printed with 5 decimals; demand agreement to print precision
    np.testing.assert_allclose(losses[0], float(m.group(1)), atol=2e-5)

    # primary-only checkpoint; proc1 redirected to a proc1/ subdir
    ckpts = glob.glob(str(tmp_path / "**" / "model_1.ckpt"), recursive=True)
    assert len(ckpts) == 1 and "proc1" not in ckpts[0], ckpts
    proc1_dirs = glob.glob(str(tmp_path / "**" / "proc1"), recursive=True)
    assert len(proc1_dirs) >= 1, proc1_dirs

    # ---- phase 2: the reference's offline-test flow — mnist-test
    # rebuilds the net from the checkpoint and dumps stored outputs ----
    outs = _run_two_process(
        ["-netType", "mnist-cluttered/mnist-test", "-retrain", ckpts[0],
         "-test"] + common,
    )
    for _, out, _ in outs:
        assert "[TESTING]" in out, out[-800:]

    h5s = glob.glob(str(tmp_path / "**" / "testOutput_1.h5"), recursive=True)
    assert len(h5s) == 1 and "proc1" not in h5s[0], h5s

    # the gathered stored outputs cover the FULL split (10 samples =
    # synthSize//4), true-sliced at the ragged tail (not padded to 16)
    import h5py

    with h5py.File(h5s[0]) as f:
        assert f["prediction"].shape[0] == 10, f["prediction"].shape


def test_single_process_fetch_global_passthrough():
    import jax.numpy as jnp

    from mgtpu.parallel.mesh import fetch_global, is_primary

    assert is_primary()
    x = jnp.arange(12.0).reshape(3, 4)
    out = fetch_global(x)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.arange(12.0).reshape(3, 4))


@pytest.mark.slow
def test_two_process_tensor_sharded_checkpoint(tmp_path):
    """-multihost -tensor with one device per process: every param/
    momentum shard lives on a DIFFERENT process, so the checkpoint path
    must all-gather collectively (every process) before the
    primary-only write — a primary-only np.asarray on such a leaf
    raises 'spans non-addressable devices'. The saved blob must carry
    FULL (unsharded) values: phase 2 proves it by -retrain'ing it in a
    plain single-process run."""
    common = [
        "-netType", "mnist-cluttered/unmg", "-dataset", "mnist-seg",
        "-data", "synthetic", "-synthSize", "16", "-batchSize", "4",
        "-nDonkeys", "0", "-cache", str(tmp_path),
    ]
    _run_two_process(
        ["-nEpochs", "1", "-epochSize", "2", "-train",
         "-nGPU", "1", "-tensor", "2", "-multihost"] + common,
        devices_per_proc=1, timeout=1500,
    )
    ckpts = glob.glob(str(tmp_path / "**" / "model_1.ckpt"), recursive=True)
    assert len(ckpts) == 1 and "proc1" not in ckpts[0], ckpts

    # phase 2: a single-process, unsharded run consumes the checkpoint
    # — shard-shaped (halved-channel) leaves would fail the load/match
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "mgtpu.main", "-retrain", ckpts[0],
         "-nGPU", "1", "-test"] + common,
        env=env, capture_output=True, text=True, cwd=REPO, timeout=560,
    )
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    assert "[TESTING]" in r.stdout, r.stdout[-800:]
