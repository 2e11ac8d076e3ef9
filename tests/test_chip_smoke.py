"""chip_smoke.py, the GPU smoke of the main path: what of it the CPU can
check (its refusal of a non-GPU backend, its contract line, its error
helpers, the in-process CLI run it parses, and its DP-vs-one-device
comparison on virtual CPU devices). The phases themselves run on the
card through `python chip_smoke.py`; the ``gpu``-marked test here runs
the reference check there and skips on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# cifar/nmg at 32 px stands in for R-MG-34: the same CLI path
# (synthetic data, donkeys, iter-size accumulation, SGD, checkpoint)
TINY = ["-data", "synthetic", "-dataset", "cifar100-whitened", "-nDonkeys", "2",
        "-batchSize", "8", "-iterSize", "2", "-netType", "cifar/nmg",
        "-nLayer", "1", "-imageSize", "36", "-imageCrop", "32",
        "-synthSize", "64"]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_refuses_cpu_backend(tmp_path, where):
    """On the CPU backend the smoke exits non-zero and prints no ok line,
    from the repo and from a directory that holds only the script."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    r = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr, r.stderr[-2000:]


@pytest.mark.parametrize("count", [1, 4])
def test_ok_line_is_the_contract(count):
    line = cs.ok_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    f'"kind": "NVIDIA H100 80GB HBM3", "count": {count}}}}}')
    assert json.loads(line)["device"]["count"] == count


@pytest.mark.parametrize("got,ref,want", [
    ([1.0, 2.0], [1.0, 2.0], 0.0),
    ([3.0, 4.0], [0.0, 0.0], float("inf")),
    ([0.0, 0.0], [0.0, 0.0], 0.0),
    ([1.0, 1.0], [1.0, 0.0], 1.0),
    ([3.0, 4.0], [3.0, 0.0], 4.0 / 3.0),
])
def test_rel_l2_hand_cases(got, ref, want):
    assert cs.rel_l2(got, ref) == pytest.approx(want)


def test_rel_l2_refuses_shape_mismatch():
    with pytest.raises(cs.SmokeFailure, match="shape"):
        cs.rel_l2(np.zeros(3), np.zeros(4))


@pytest.mark.parametrize("value,passes", [
    (1e-3, True), (1e-2, True), (1.1e-2, False), (float("nan"), False),
])
def test_check_against_tolerance(capsys, value, passes):
    if passes:
        assert cs.check("err", value, 1e-2) == value
        assert "ok" in capsys.readouterr().out
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.check("err", value, 1e-2)
        assert "FAIL" in capsys.readouterr().out


def test_centred_removes_row_offset():
    out = np.array([[1.0, 2.0, 3.0], [10.0, 10.0, 13.0]])
    np.testing.assert_allclose(cs.centred(out + 5.0), cs.centred(out))
    np.testing.assert_allclose(cs.centred(out).sum(-1), 0.0, atol=1e-12)


def test_step_line_parser_reads_cli_log():
    """The smoke reads step losses from the CLI's own per-iteration line
    (mgtpu/pipelines/standard.py), so the two formats must agree."""
    line = ("10/16/26 04:10:41 Epoch: [1][2/3]\tRun:0.288s lr:1.000e-01 "
            "Data:0.001s loss:9.78901 top1:0.00000 top5:0.01172")
    assert cs._STEP.findall(line) == [("2", "0.288", "9.78901")]


def test_phase_train_tiny(tmp_path, capsys):
    """The train phase end to end at a tiny width: mgtpu.main in-process,
    step losses parsed and finite, memory_analysis of the train step."""
    cs.phase_train(cs.CompileClock(), str(tmp_path), "float32", recipe=TINY, steps=2)
    out = capsys.readouterr().out
    assert "step 2: loss" in out and "memory_analysis train step" in out


def test_dp_compare_four_virtual_devices(tmp_path):
    """-nGPU 4 against -nGPU 1 on the same global batch: on CPU (exact
    float32) loss and parameter change agree far inside the tolerances
    the smoke holds the GPUs to."""
    loss_diff, prel = cs.dp_compare(TINY, 4, str(tmp_path))
    assert loss_diff <= 1e-4 and prel <= 1e-3, (loss_diff, prel)
    assert loss_diff <= cs.TOL_DP_LOSS and prel <= cs.TOL_DP_PARAMS


@pytest.mark.gpu
def test_reference_check_on_gpu(gpu, capsys):
    """bf16 and TF32 forwards against float32 'highest' on the card, at a
    small width (the smoke runs the same check on R-MG-34)."""
    import types

    import jax
    import jax.numpy as jnp

    from mgtpu.models import get_net

    net = get_net("cifar/rnmg")
    mk = lambda dt: net.create_model(types.SimpleNamespace(
        nLayer=1, dataset="cifar100-whitened", compute_dtype=dt))
    m32, m16 = mk(None), mk(jnp.bfloat16)
    params, stats = jax.jit(m32.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 100, 8).astype(np.int32)
    ref = cs.phase_reference(cs.CompileClock(), m32, m16, params, stats, x, y)
    assert ref.shape == (8, 100)
    assert "FAIL" not in capsys.readouterr().out
