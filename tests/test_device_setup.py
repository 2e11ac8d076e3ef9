"""What the program needs from the machine it runs on: the compile-cache
location, the device count it asks for, the multi-host endpoint, donkey
workers that stay off the accelerator, and a main path that needs no
Pillow."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from mgtpu import main as mgmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,cwd", [("set", "repo"), ("unset", "repo"), ("unset", "tmp")])
def test_compile_cache_dir(tmp_path, monkeypatch, env, cwd):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is
    <repo>/.jax_cache whatever the working directory."""
    monkeypatch.chdir(REPO if cwd == "repo" else tmp_path)
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
        assert mgmain.compile_cache_dir() == str(tmp_path / "cc")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert mgmain.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("env", ["set", "unset"])
def test_init_compile_cache_sets_config_only_without_env(tmp_path, monkeypatch, env):
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env == "set":
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert mgmain.init_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir is None  # JAX reads the env itself
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = mgmain.init_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_flag_does_not_move_compile_cache(tmp_path, monkeypatch):
    """-cache places run logs and checkpoints, never the compile cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    try:
        with pytest.raises(SystemExit):  # stops in Session, past the cache setup
            mgmain.main(["-netType", "cifar/nmg", "-dataset", "cifar100-whitened",
                         "-data", "synthetic", "-nLayer", "1", "-nGPU", "99",
                         "-train", "-cache", str(tmp_path / "elsewhere")])
        assert jax.config.jax_compilation_cache_dir == os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_ngpu_above_device_count_is_refused(tmp_path):
    n = jax.device_count()
    with pytest.raises(SystemExit, match=rf"-nGPU {n + 1} .*: {n} devices"):
        mgmain.main(["-netType", "cifar/nmg", "-dataset", "cifar100-whitened",
                     "-data", "synthetic", "-nLayer", "1", "-nGPU", str(n + 1),
                     "-train", "-cache", str(tmp_path)])


def test_multihost_without_coordinator_is_refused(monkeypatch):
    from mgtpu.parallel.mesh import init_multihost

    for k in ("MGTPU_COORDINATOR", "MGTPU_NUM_PROCESSES", "MGTPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="MGTPU_COORDINATOR"):
        init_multihost()


def test_process_donkey_stays_on_cpu(monkeypatch):
    """A process-mode donkey must never open the GPU: its initializer
    pins JAX to the CPU before anything in the worker imports JAX."""
    from mgtpu.data import prefetch

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setattr(prefetch, "_WORKER_OPT", None)
    monkeypatch.setattr(prefetch, "_WORKER_LOADERS", None)
    prefetch._init_worker({})
    assert os.environ["JAX_PLATFORMS"] == "cpu"


_NO_PIL = """
import sys, types
sys.modules["PIL"] = None  # import PIL now raises ImportError
import numpy as np
from mgtpu import native
from mgtpu.data import transforms
assert native.available(), "native data library did not build"
{body}
print("OK")
"""

_NO_PIL_BODIES = {
    "transforms": """
img = np.random.default_rng(0).random((40, 48, 3), dtype=np.float32)
out = transforms.scale(32)(img, np.random.default_rng(1))
assert out.shape[2] == 3 and min(out.shape[:2]) == 32, out.shape
""",
    "ilsvrc_batch": """
from mgtpu.data import get_loaders
from mgtpu.utils.opts import parse
opt = parse(["-netType", "ilsvrc/rnmg", "-dataset", "ilsvrc", "-data",
             "synthetic", "-synthSize", "8", "-depth", "18", "-train"])
x, y = get_loaders(opt)["train"].sample(2, np.random.default_rng(0))
assert x.shape == (2, 224, 224, 3) and np.isfinite(x).all(), x.shape
""",
}


@pytest.mark.parametrize("case", sorted(_NO_PIL_BODIES))
def test_main_path_runs_without_pillow(case):
    code = _NO_PIL.format(body=_NO_PIL_BODIES[case])
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]


def test_pillow_fallback_names_what_is_missing(monkeypatch):
    from mgtpu.data import ilsvrc, transforms

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(transforms, "_HAVE_NATIVE", False)
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(ImportError, match="Pillow"):
        transforms._resize(img, 4, 4)
    with pytest.raises(ImportError, match="Pillow"):
        ilsvrc.load_image("some.jpg")
