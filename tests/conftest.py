"""Suite-wide setup.

1. Force 8 host platform devices *before* any ``import jax`` so every test
   module sees a multi-device topology -- the distributed tests
   (``test_distributed*.py``, the shard_map parity tests in
   ``test_core_partition.py`` / ``test_train.py``) run inline instead of
   each spawning a subprocess with its own XLA_FLAGS.
2. Seed the global RNGs per test for reproducibility.
3. Register a ``slow`` marker.  Slow-marked tests (heavy model smoke /
   serve decode loops) are skipped by default so tier-1 stays fast; run
   them with ``-m slow`` or ``RUN_SLOW=1``.
"""
import os
import random

_FLAG = "--xla_force_host_platform_device_count=8"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _FLAG).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy smoke test, skipped unless -m slow or RUN_SLOW=1")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (hand-written kernels); skips without one")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RUN_SLOW") or config.getoption("-m"):
        return
    skip = pytest.mark.skip(reason="slow: run with -m slow or RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _seed_rngs():
    random.seed(0)
    np.random.seed(0)
    yield
