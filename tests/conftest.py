"""Test config: force an 8-device virtual CPU platform so data-parallel
sharding paths are exercised without accelerators (the rebuild analog
of the reference's `-nDonkeys 0` synchronous debug mode,
`data.lua:32-37`). XLA_FLAGS and JAX_PLATFORMS must be set before JAX
initializes its backend; subprocesses the tests spawn inherit them.

The persistent compilation cache is off: the tests compile tiny shapes,
and concurrent workers gain nothing from sharing one on-disk cache.
Tests marked ``gpu`` need an NVIDIA GPU and skip without one (the
``gpu`` fixture decides at run time); ``python chip_smoke.py`` is the
command that exercises those paths on the card."""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Smoke tier: a curated <5-min-on-1-core subset for quick loops, chosen
# from the per-test durations of the full fast tier. Run with
# `pytest -m smoke`.
# Coverage: at least one test per subsystem; compile-heavy e2e tests
# (checkpoint roundtrips, CLI integration, DP-vs-single-device) stay in
# the fast tier only.
SMOKE_NODEID_SUBSTRINGS = (
    # option parsing + launch recipes
    "test_scripts.py::",
    # native C++ data plane
    "test_native.py::",
    # dataset registry / loaders / donkeys
    "test_data.py::",
    # resampling ops
    "test_resample.py::",
    "test_resample_properties.py::test_avgpool2_matches_naive",
    "test_resample_properties.py::test_ceil_pad_reproduces_torch_output_size",
    "test_resample_properties.py::test_maxpool_3x3_stride2_matches_naive",
    # t7 interop (incl. writer-independent golden bytes)
    "test_t7.py::",
    # zoo: all param pins + one full build/forward
    "test_zoo.py::test_model_param_counts",
    "test_zoo.py::test_model_builds_and_forwards[cifar/nmg-",
    # mg block library
    "test_mg_ops.py::test_mg_conv",
    "test_mg_ops.py::test_bn_custom_vjp_matches_naive_autodiff",
    "test_mg_ops.py::test_resample_concat_values",
    "test_mg_ops.py::test_mg_pool_modes",
    "test_mg_ops.py::test_bce_loss_saturated_sigmoid_finite",
    # train step / sharding specs / optimizer
    "test_train_dp.py::test_sgd_matches_reference_semantics",
    "test_train_dp.py::test_sgd_bucketed_matches_per_leaf",
    "test_train_dp.py::test_constrain_spatial_spec_logic",
    "test_train_dp.py::test_tp_sharding_spec_logic",
    "test_train_dp.py::test_shard_batch_spatial_spec_layouts",
    # serving-path transforms
    "test_fold_bn.py::test_convbn_fold_exact",
    "test_fused_exchange.py::test_conv_up3_folding_exact",
    "test_fused_exchange.py::test_conv_up3_gradients_match",
    # saliency probe
    "test_saliency.py::test_device_probe_matches_host",
    # host-cast transfer path
    "test_host_cast.py::test_pooled_stem_allclose",
    # offline tooling
    "test_tools.py::test_bench_data_synthetic",
    "test_tools.py::test_zca_exact_mathematical_pins",
    "test_tools.py::test_seg_metrics_hand_case",
    "test_tools.py::test_generate_mnist_cluttered_segmentation",
    "test_tools.py::test_render_predictions_panels",
    # logging + multihost helpers
    "test_logging.py::",
    "test_multihost.py::test_single_process_fetch_global_passthrough",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.get_closest_marker("slow"):
            continue
        if any(s in item.nodeid for s in SMOKE_NODEID_SUBSTRINGS):
            item.add_marker(pytest.mark.smoke)


@pytest.fixture
def gpu():
    """The first device, when it is an NVIDIA GPU; skips otherwise.
    Decided here, at run time, never at import or collection: every
    xdist worker must collect the same tests."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX has {devs[0].platform}); "
                    "run by `python chip_smoke.py` on the card")
    return devs[0]
