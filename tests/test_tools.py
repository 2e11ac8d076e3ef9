"""End-to-end tests for the offline tools (SURVEY §2.7): IDX MNIST
ingest, cluttered-MNIST task generation, CIFAR ZCA ingest, and the
offline meanIU/meanAcc computation. Each drives the real CLI via its
main() with constructed inputs in tmp dirs."""

import gzip
import json
import os
import pickle
import struct
import subprocess
import sys

import numpy as np
import pytest

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _run(tool, *args):
    r = subprocess.run(
        [sys.executable, os.path.join(TOOLS, tool), *args],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def _write_idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    magic = 0x800 + arr.ndim
    header = struct.pack(f">i{arr.ndim}i", magic, *arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + arr.tobytes())


def test_download_mnist_idx_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    src = tmp_path / "raw"
    src.mkdir()
    tri = rng.integers(0, 255, (60000, 28, 28), np.uint8)
    trl = rng.integers(0, 10, (60000,), np.uint8)
    tei = rng.integers(0, 255, (10000, 28, 28), np.uint8)
    tel = rng.integers(0, 10, (10000,), np.uint8)
    _write_idx(src / "train-images-idx3-ubyte.gz", tri)
    _write_idx(src / "train-labels-idx1-ubyte.gz", trl)
    _write_idx(src / "t10k-images-idx3-ubyte.gz", tei)
    _write_idx(src / "t10k-labels-idx1-ubyte.gz", tel)
    out = tmp_path / "mnist.npz"
    _run("download_mnist.py", "--src", str(src), "--out", str(out))
    z = np.load(out)
    assert z["train_images"].shape == (50000, 28, 28)
    assert z["valid_images"].shape == (10000, 28, 28)
    assert z["test_images"].shape == (10000, 28, 28)
    np.testing.assert_array_equal(z["train_images"], tri[:50000])
    np.testing.assert_array_equal(z["valid_labels"], trl[50000:])


def test_generate_mnist_cluttered_segmentation(tmp_path):
    rng = np.random.default_rng(1)
    # tiny fake mnist.npz with digit-ish blobs
    def blobs(n):
        imgs = np.zeros((n, 28, 28), np.uint8)
        for i in range(n):
            y, x = rng.integers(6, 18, 2)
            imgs[i, y : y + 8, x : x + 8] = 255
        return imgs
    npz = tmp_path / "mnist.npz"
    np.savez(npz,
             train_images=blobs(40), train_labels=np.arange(40) % 10,
             valid_images=blobs(20), valid_labels=np.arange(20) % 10,
             test_images=blobs(20), test_labels=np.arange(20) % 10)
    _run("generate_mnist_cluttered.py", "--mnist", str(npz),
         "--task", "segmentation", "--out-dir", str(tmp_path),
         "--scale", "0.002")
    z = np.load(tmp_path / "mnist_segmentation.npz")
    assert z["train_inputs"].shape[1:3] == (64, 64)
    assert z["train_targets"].shape[-1] == 10  # 10-channel class masks
    assert z["test_inputs"].shape[0] == 2
    assert 0.0 <= z["train_inputs"].max() <= 1.0


def test_ingest_cifar_whitening(tmp_path):
    rng = np.random.default_rng(2)
    d = tmp_path / "cifar-100-python"
    d.mkdir(parents=True)
    def dump(split, n):
        with open(d / split, "wb") as f:
            pickle.dump({
                "data": rng.integers(0, 255, (n, 3072), np.uint8),
                "fine_labels": (np.arange(n) % 100).tolist(),
            }, f)
    dump("train", 240)
    dump("test", 60)
    out = tmp_path / "w.npz"
    _run("ingest_cifar.py", "--root", str(tmp_path), "--dataset", "cifar100",
         "--whiten", "--out", str(out))
    z = np.load(out)
    assert z["train_data"].shape == (240, 3072)
    assert z["train_labels"].shape == (240,)
    # ZCA decorrelates: off-diagonal covariance shrinks vs raw
    x = z["train_data"].astype(np.float64)
    cov = np.cov(x[:, :64], rowvar=False)
    off = np.abs(cov - np.diag(np.diag(cov))).mean()
    assert off < np.abs(np.diag(cov)).mean()


def test_seg_metrics_hand_case():
    sys.path.insert(0, TOOLS)
    from seg_metrics import mean_iu_acc

    pred = np.zeros((1, 4, 4, 2), np.float32)
    lab = np.zeros((1, 4, 4, 2), np.float32)
    pred[0, :2, :2, 0] = 1.0   # 4 predicted px class 0
    lab[0, :2, :3, 0] = 1.0    # 6 true px: TP=4, mism=2 -> IU0=4/6, Acc0=1
    lab[0, 3, 3, 1] = 1.0      # class 1: TP=0 -> IU1=0, Acc1=0
    iu, acc = mean_iu_acc(pred, lab, threshold=0.5)
    np.testing.assert_allclose(iu, (4 / 6 + 0) / 2, rtol=1e-6)
    np.testing.assert_allclose(acc, (1.0 + 0) / 2, rtol=1e-6)


def test_bench_data_synthetic():
    out = _run("bench_data.py", "-dataset", "cifar100-whitened",
               "-batchSize", "8", "-iters", "3", "-workers", "2",
               "-synthSize", "64", "-imageSize", "36", "-imageCrop", "32")
    row = json.loads(out.strip().splitlines()[-1])
    assert row["workers"] == 2 and row["images_per_sec"] > 0


def test_model_info_rmg34_matches_published_counts():
    """R-MG-34 params/MACs from jaxpr analysis must match the reference
    README's published 32.9M / 5.76G (`README.md:109`)."""
    env = dict(os.environ, MGTPU_NO_FUSED_EXCHANGE="1", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "model_info.py"),
         "-netType", "ilsvrc/rnmg", "-depth", "34", "-imageCrop", "224"],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    row = json.loads(r.stdout.strip().splitlines()[-1])
    assert row["params"] == 32_899_176
    assert row["macs_per_image"] == 5_760_277_760


@pytest.mark.slow  # jax.export + reload compile
def test_export_serve_roundtrip(tmp_path):
    """StableHLO export -> deserialize -> call must reproduce the live
    model's forward exactly (tools/export_model.py + serve_exported.py)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    art = tmp_path / "mg6.shlo"
    r = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "export_model.py"),
         "-netType", "cifar/nmg", "-nLayer", "1", "-batch", "2",
         "-imageCrop", "32", "-dtype", "float32",
         "-platforms", "cpu", "-out", str(art)],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert art.stat().st_size > 1_000_000  # weights baked in

    import types

    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    from mgtpu.models import get_net

    with open(art, "rb") as f:
        exp = jexport.deserialize(bytearray(f.read()))
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    got = np.asarray(exp.call(jnp.asarray(x)))

    net = get_net("cifar/nmg")
    model = net.create_model(types.SimpleNamespace(nLayer=1, nEpochs=200,
                                                   shortcutType="A"))
    params, stats = jax.jit(model.init)(jax.random.PRNGKey(0))
    ref = np.asarray(model.apply(params, stats, jnp.asarray(x), train=False)[0])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_zca_exact_mathematical_pins():
    """Offline verification of the whitening recipe (the published blob
    is unavailable on a zero-egress box; these pins make a future data
    drop turnkey — PARITY 'convergence protocol'): GCN rows have norm
    55 (pylearn2 convention), the ZCA matrix is symmetric, and the
    whitened train covariance's eigenvalues are exactly s/(s+eps) with
    eps=0.1 — near-1 for high-variance directions."""
    sys.path.insert(0, TOOLS)
    from ingest_cifar import gcn, zca_fit

    rng = np.random.default_rng(0)
    # anisotropic data so the covariance has real structure
    basis = rng.normal(size=(48, 48))
    x = rng.normal(size=(600, 48)) @ (basis * np.geomspace(1, 30, 48))

    g = gcn(x)
    np.testing.assert_allclose(np.linalg.norm(g, axis=1), 55.0, rtol=1e-6)
    np.testing.assert_allclose(g.mean(axis=1), 0.0, atol=1e-9)

    mean, w = zca_fit(g, eps=0.1)
    np.testing.assert_allclose(w, w.T, atol=1e-9)  # zero-phase

    xw = (g - mean) @ w
    cov = xw.T @ xw / len(xw)
    evals = np.sort(np.linalg.eigvalsh(cov))
    s = np.sort(np.linalg.eigvalsh((g - mean).T @ (g - mean) / len(g)))
    np.testing.assert_allclose(evals, s / (s + 0.1), rtol=1e-7, atol=1e-9)


def test_render_predictions_panels(tmp_path):
    """tools/render_predictions.py renders input|target|prediction rows
    from a test h5 dump + task npz (the reference's
    figures/spatial_transform.png panels, README.md:137-150): auto mode
    picks gray for single-digit targets and seg for multi-digit ones,
    and the prediction cell reflects the h5 values (dark where
    confident, white where empty)."""
    import h5py
    from PIL import Image

    h, w, c, n = 16, 16, 10, 3
    inputs = np.zeros((n, h, w, 1), np.float32)
    targets = np.zeros((n, h, w, c), np.float32)
    pred = np.zeros((n, h, w, c), np.float32)
    inputs[:, 4:12, 4:12, 0] = 1.0
    targets[:, 4:12, 4:12, 3] = 1.0  # single class -> auto picks gray
    pred[:, 4:12, 4:12, 3] = 1.0
    np.savez(tmp_path / "task.npz", test_inputs=inputs, test_targets=targets)
    with h5py.File(tmp_path / "testOutput_1.h5", "w") as f:
        f.create_dataset("prediction", data=pred)
    _run("render_predictions.py", str(tmp_path / "testOutput_1.h5"),
         "--targets", str(tmp_path / "task.npz"), "--out", str(tmp_path),
         "--ids", "0", "1")
    img = np.asarray(Image.open(tmp_path / "predictions_gray.png"))
    pad, scale = 2, 3
    assert img.shape == ((2 * h + 3 * pad) * scale, (3 * w + 4 * pad) * scale, 3)
    # prediction cell (row 0, col 2): dark at the digit, white outside
    y0, x0 = pad * scale, (pad * 3 + 2 * w) * scale
    assert img[y0 + 8 * scale, x0 + 8 * scale].max() < 60       # digit
    assert img[y0 + 1 * scale, x0 + 1 * scale].min() > 200      # empty
    # multi-class target -> auto picks seg (colored tints)
    targets[:, 2:6, 2:6, 7] = 1.0
    np.savez(tmp_path / "task.npz", test_inputs=inputs, test_targets=targets)
    _run("render_predictions.py", str(tmp_path / "testOutput_1.h5"),
         "--targets", str(tmp_path / "task.npz"), "--out", str(tmp_path),
         "--ids", "0")
    seg = np.asarray(Image.open(tmp_path / "predictions_seg.png"))
    ty, tx = pad * scale, (pad * 2 + w) * scale  # target cell, class-3 zone
    px = seg[ty + 8 * scale, tx + 8 * scale].astype(float)
    assert px[0] > px[2] > px[1]  # tab10 class-3 red tint: R > B > G
    # a .png --out is a file path, not a directory to fill
    _run("render_predictions.py", str(tmp_path / "testOutput_1.h5"),
         "--targets", str(tmp_path / "task.npz"),
         "--out", str(tmp_path / "sub" / "exact.png"), "--ids", "0")
    exact = np.asarray(Image.open(tmp_path / "sub" / "exact.png"))
    assert exact.shape == seg.shape and not (tmp_path / "sub" / "exact.png").is_dir()


@pytest.mark.parametrize("kind,known", [
    ("NVIDIA H100 80GB HBM3", True),
    ("cpu", False),
    ("NVIDIA A100-SXM4-80GB", False),
    ("NVIDIA H100", False),  # exact kind only, no prefix match
])
def test_bench_peak_lookup(kind, known):
    """bench.py's peaks are keyed by exact device_kind; any other device,
    the CPU included, is an error rather than a borrowed peak."""
    import bench

    if known:
        peaks = bench.device_peaks(kind)
        assert peaks["bf16_flops"] == 989e12 and peaks["hbm_bytes_per_s"] == 3.35e12
    else:
        with pytest.raises(SystemExit, match="no peak rates"):
            bench.device_peaks(kind)


def _trace(procs, events):
    meta = [{"ph": "M", "name": "process_name", "pid": pid, "args": {"name": n}}
            for pid, n in procs.items()]
    meta += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
              "args": {"name": n}} for (pid, tid), n in THREADS.items()]
    return {"traceEvents": meta + events}


THREADS = {(1, 1): "python", (2, 10): "XLA Modules", (2, 11): "Stream #13(Compute)"}


@pytest.mark.parametrize("procs,events", [
    ({}, []),
    ({1: "/host:CPU"}, [{"ph": "X", "pid": 1, "tid": 1, "name": "jit_step", "dur": 5.0}]),
    # a device whose only events are summary rows
    ({2: "/device:GPU:0"}, [{"ph": "X", "pid": 2, "tid": 10, "name": "jit_step", "dur": 9.0}]),
])
def test_profile_summary_refuses_trace_without_device_events(procs, events):
    sys.path.insert(0, TOOLS)
    from profile_summary import summarize

    with pytest.raises(ValueError, match="no device events"):
        summarize(_trace(procs, events))


def test_profile_summary_sums_gpu_kernels():
    sys.path.insert(0, TOOLS)
    from profile_summary import summarize

    ev = lambda tid, name, dur: {"ph": "X", "pid": 2, "tid": tid, "name": name, "dur": dur}
    trace = _trace({1: "/host:CPU", 2: "/device:GPU:0"}, [
        ev(10, "jit_train_step", 100.0),  # module row: not counted
        ev(11, "cudnn_conv_fwd", 30.0), ev(11, "cudnn_conv_fwd", 20.0),
        ev(11, "loop_fusion", 7.0),
        {"ph": "X", "pid": 1, "tid": 1, "name": "dispatch", "dur": 50.0},
    ])
    total, by_cat, by_op = summarize(trace)
    assert total == 57.0
    assert by_op == {"cudnn_conv_fwd": 50.0, "loop_fusion": 7.0}
    assert by_cat == by_op  # GPU kernel events carry no hlo_category
