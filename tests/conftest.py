import os
import sys

# NOTE: no XLA_FLAGS here on purpose — unit/smoke tests must see the real
# single CPU device. Multi-device tests spawn subprocesses that set
# --xla_force_host_platform_device_count themselves (see test_dist.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without them)"
    )
