"""End-to-end CLI integration: the checkpoint-harness chain the
reference used for its published segmentation metrics —
train unmg -> reload through the mnist-test harness model (-retrain)
-> testOutput h5 dump -> offline seg_metrics. Locks the h5 layout, the
harness reload path (`models/mnist-cluttered/mnist-test.lua` +
`model.lua:28-31`), and the notebook-turned-CLI metric chain."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _main(*args, timeout=560):
    env = dict(
        os.environ,
        PYTHONPATH=REPO,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    r = subprocess.run(
        [sys.executable, "-m", "mgtpu.main", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    return r.stdout


@pytest.mark.slow
def test_seg_harness_chain(tmp_path):
    common = [
        "-dataset", "mnist-seg", "-data", "synthetic", "-synthSize", "32",
        "-batchSize", "8", "-nGPU", "1", "-nDonkeys", "0",
        "-cache", str(tmp_path),
    ]
    # 1) short unmg training run with a checkpoint
    out = _main("-netType", "mnist-cluttered/unmg", *common,
                "-nEpochs", "1", "-epochSize", "2", "-train", "-test")
    ckpts = glob.glob(str(tmp_path / "**" / "model_1.ckpt"), recursive=True)
    assert len(ckpts) == 1
    m = re.search(r"avg\.loss:([0-9.]+).*avg\.meanIU:([0-9.]+)", out)
    assert m, out[-800:]
    train_loss, train_iu = float(m.group(1)), float(m.group(2))

    # 2) offline harness: -retrain reloads the checkpoint with zero
    #    architecture code and must reproduce the SAME test metrics
    out2 = _main("-netType", "mnist-cluttered/mnist-test", *common,
                 "-nEpochs", "1", "-retrain", ckpts[0], "-test")
    m2 = re.search(r"avg\.loss:([0-9.]+).*avg\.meanIU:([0-9.]+)", out2)
    assert m2, out2[-800:]
    np.testing.assert_allclose(float(m2.group(1)), train_loss, rtol=1e-4)
    np.testing.assert_allclose(float(m2.group(2)), train_iu, rtol=1e-4)

    # 3) the harness stores predictions; seg_metrics consumes the dump
    h5s = glob.glob(str(tmp_path / "**" / "testOutput_1.h5"), recursive=True)
    assert h5s, "harness run must dump stored predictions"
    import h5py

    with h5py.File(sorted(h5s)[-1], "r") as f:
        assert "prediction" in f
        pred = np.asarray(f["prediction"])
    assert pred.shape[0] == 8  # synthSize 32 // 4 test samples
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from seg_metrics import mean_iu_acc

    # synthetic targets: rebuild the loader the same way the run did
    import types

    from mgtpu.data import get_loaders

    opt = types.SimpleNamespace(
        dataset="mnist-seg", data="synthetic", synthSize=32, manualSeed=2,
        imageSize=256, imageCrop=224, colorspace="bgr", dataAug="default",
        tenCrop=False, nEpochs=1,
    )
    loader = get_loaders(opt)["test"]
    _, targets = loader.get_inputs(1, loader.size(), 1)
    iu, acc = mean_iu_acc(pred, targets)
    assert 0.0 <= iu <= 1.0 and 0.0 <= acc <= 1.0


@pytest.mark.slow
def test_train_eval_test_three_splits(tmp_path):
    """-train -eval -test on mnist-seg drives three DISTINCT splits
    (`pipelines/standard/eval.lua:18-84`): the eval pass must use the
    val split, not silently re-read test."""
    out = _main(
        "-netType", "mnist-cluttered/unmg", "-dataset", "mnist-seg",
        "-data", "synthetic", "-synthSize", "32", "-batchSize", "8",
        "-nGPU", "1", "-nDonkeys", "0", "-cache", str(tmp_path),
        "-nEpochs", "1", "-epochSize", "2", "-train", "-eval", "-test",
    )
    assert "doing epoch on eval data" in out
    assert "doing epoch on test data" in out
    assert "WARNING: -eval requested" not in out
    me = re.search(r"\[EVALUATION\].*avg\.loss:([0-9.]+)", out)
    mt = re.search(r"\[TESTING\].*avg\.loss:([0-9.]+)", out)
    assert me and mt, out[-800:]
    # different splits -> different data -> (almost surely) different loss
    assert me.group(1) != mt.group(1), out[-800:]

    # cifar provides no eval split: the fallback must be loud
    out2 = _main(
        "-netType", "cifar/nmg", "-dataset", "cifar100-whitened",
        "-data", "synthetic", "-synthSize", "64", "-nLayer", "1",
        "-batchSize", "8", "-imageSize", "36", "-imageCrop", "32",
        "-nGPU", "1", "-nDonkeys", "0", "-cache", str(tmp_path),
        "-nEpochs", "1", "-epochSize", "2", "-train", "-eval",
    )
    assert "WARNING: -eval requested" in out2


@pytest.mark.slow
def test_tensor_parallel_cli(tmp_path):
    """-tensor 2 end-to-end: train+test on a 4x2 data x tensor mesh
    with channel-sharded params; and the -spatial/-tensor conflict is
    rejected before any compile."""
    out = _main(
        "-netType", "cifar/nmg", "-dataset", "cifar100-whitened",
        "-data", "synthetic", "-synthSize", "64", "-nLayer", "1",
        "-batchSize", "8", "-imageSize", "36", "-imageCrop", "32",
        "-nGPU", "4", "-tensor", "2", "-nDonkeys", "0",
        "-cache", str(tmp_path),
        "-nEpochs", "1", "-epochSize", "2", "-train", "-test",
    )
    assert re.search(r"avg\.loss:[0-9.]+", out), out[-800:]

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-m", "mgtpu.main", "-netType", "cifar/nmg",
         "-dataset", "cifar100-whitened", "-data", "synthetic",
         "-spatial", "2", "-tensor", "2", "-cache", str(tmp_path),
         "-train"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO,
    )
    assert r.returncode != 0
    assert "-spatial and -tensor" in (r.stdout + r.stderr)


def test_cifar_eval_split_cli(tmp_path):
    """-evalSplit makes -eval real for CIFAR: eval epoch runs on the
    carved split with no fallback warning; -evalSplit 0 keeps the loud
    fallback (exercised by test_train_eval_test_three_splits)."""
    out = _main(
        "-netType", "cifar/nmg", "-dataset", "cifar100-whitened",
        "-data", "synthetic", "-synthSize", "300", "-nLayer", "1",
        "-batchSize", "8", "-imageSize", "36", "-imageCrop", "32",
        "-nGPU", "1", "-nDonkeys", "0", "-cache", str(tmp_path),
        "-nEpochs", "1", "-epochSize", "2", "-evalSplit", "1",
        "-train", "-eval", "-test",
    )
    assert "doing epoch on eval data" in out
    assert "WARNING: -eval requested" not in out
    me = re.search(r"\[EVALUATION\].*avg\.loss:([0-9.]+)", out)
    mt = re.search(r"\[TESTING\].*avg\.loss:([0-9.]+)", out)
    assert me and mt, out[-800:]
    assert me.group(1) != mt.group(1), "eval ran on the test split?"


@pytest.mark.slow
def test_stop_after_bounded_chunk_resumes(tmp_path):
    """-stopAfter: exit cleanly after the given epoch with a checkpoint
    even off the -nEpochsSave cadence, WITHOUT changing -nEpochs (the
    LR schedule input); a resume from that checkpoint continues the
    epoch numbering, so a long run can be split into bounded chunks."""
    common = [
        "-netType", "cifar/nmg", "-dataset", "cifar100-whitened",
        "-data", "synthetic", "-synthSize", "48", "-batchSize", "8",
        "-imageSize", "36", "-imageCrop", "32", "-nLayer", "1",
        "-nGPU", "1", "-nDonkeys", "0", "-cache", str(tmp_path),
        "-nEpochs", "4", "-epochSize", "2", "-nEpochsSave", "99",
    ]
    out = _main(*common, "-stopAfter", "2", "-train")
    assert "stopping after epoch 2 (-stopAfter)" in out
    assert "Epoch: [3]" not in out
    ckpts = glob.glob(str(tmp_path / "**" / "model_2.ckpt"), recursive=True)
    assert len(ckpts) == 1  # saved despite nEpochsSave=99

    out2 = _main(*common, "-retrain", ckpts[0], "-epochNumber", "3",
                 "-stopAfter", "3", "-train")
    assert "Epoch: [3]" in out2 and "Epoch: [4]" not in out2
