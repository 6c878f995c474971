"""Test configuration.

JAX-facing tests run on a virtual 8-device CPU mesh so the multi-device
sharding paths execute in CI without accelerators (SURVEY.md §4's strategy
for the rebuild).  These env vars must be set before jax is first imported.
"""

import os

# Force CPU even where an accelerator is attached or jax was imported before
# this file ran (env vars are then too late): jax.config.update wins over
# the already-captured env value.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# tests never read or write the persistent compile cache that the entry
# points (cli.main, bench.py, chip_smoke.py) enable
jax.config.update("jax_enable_compilation_cache", False)

import pathlib
import re

import numpy as np
import pytest

REFERENCE_TEST_DATA = pathlib.Path("/root/reference/test_data")

# Smoke profile: `pytest -m "not slow"` skips the compile-heavy tests listed
# in slow_tests.txt (regenerate with tools/regen_slow_list.py).  Matching is
# on the de-parametrized nodeid, so one line covers all parametrizations.
_SLOW_LIST = pathlib.Path(__file__).parent / "slow_tests.txt"
_SLOW_IDS = frozenset(
    line.strip()
    for line in _SLOW_LIST.read_text().splitlines()
    if line.strip() and not line.startswith("#")
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if "::" not in item.nodeid:
            continue
        path, rest = item.nodeid.split("::", 1)
        fname = path.rsplit("/", 1)[-1]
        base = re.sub(r"\[.*\]$", "", f"tests/{fname}::{rest}")
        if base in _SLOW_IDS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules.

    XLA:CPU segfaults (reproducibly, in backend_compile_and_load) when one
    big fused compile runs late in a process already holding the whole
    suite's accumulated executables; every subset of the suite passes.
    Modules rarely share exact compile keys, so the per-module recompile
    cost is small, and no single compile ever sees the full accumulation.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def ref_rgb_tif():
    p = REFERENCE_TEST_DATA / "sample_rgb.tif"
    if not p.exists():
        pytest.skip("reference test data not available")
    return p


@pytest.fixture
def ref_rgb_flac():
    p = REFERENCE_TEST_DATA / "sample_rgb.flac"
    if not p.exists():
        pytest.skip("reference test data not available")
    return p
