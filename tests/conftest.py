"""Test configuration: run everything on a virtual 8-device CPU mesh, so
the sharding tests run without accelerators."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running parity runs; skipped unless RUN_SLOW=1")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow parity run; set RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def lfr_paths():
    base = "/root/reference/example"
    return {
        "network": f"{base}/LFR-network-n1000-k28.txt",
        "ground_truth": f"{base}/LFR-ground-truth-n1000-k28.txt",
    }


@pytest.fixture(scope="session")
def assort_path():
    return "/root/reference/example/assort-75-4.txt"
