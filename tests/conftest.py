import os
import sys

# NOTE: no XLA_FLAGS here on purpose — unit/smoke tests must see the real
# single CPU device.  Multi-device tests spawn subprocesses that set
# --xla_force_host_platform_device_count themselves (test_distributed.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running system/e2e tests (CI fast lane runs -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips without one (run on the card)",
    )
