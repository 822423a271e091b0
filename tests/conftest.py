import os

# Tests run on the host's real device count (1 CPU).  The 512-device flag
# belongs ONLY to launch/dryrun.py; subprocess-based integration tests set
# their own XLA_FLAGS.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels); skips without one")
