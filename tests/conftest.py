import os
import sys

# NOTE: no XLA_FLAGS here on purpose -- smoke tests and benches must see the
# single real CPU device.  Multi-device tests spawn subprocesses that set
# --xla_force_host_platform_device_count themselves.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.data.synthetic import make_dlrm_pool, make_prod_pool  # noqa: E402
from repro.sim.costsim import CostSimulator  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture(scope="session")
def dlrm_pool():
    return make_dlrm_pool(seed=0)


@pytest.fixture(scope="session")
def prod_pool():
    return make_prod_pool(seed=1)


@pytest.fixture()
def sim():
    return CostSimulator(seed=0)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def telemetry():
    """Enabled telemetry with clean counters; restores the disabled
    default (and clears again) on teardown, so no counter state leaks
    between tests."""
    from repro import telemetry as tele
    tele.reset()
    tele.enable()
    yield tele
    tele.reset()
    tele.disable()


@pytest.fixture(scope="session")
def save_v1_calibration():
    """Writer for the exact pre-fusion (v1) artifact format, shared by
    the v1-fallback tests (test_profiling, test_fusion_properties)."""
    import json

    def _save(table, path):
        scalar = {"comm": table.comm.to_dict(),
                  "fingerprint": table.fingerprint,
                  "version": 1, "meta": table.meta}
        np.savez(path, dims=table.dims, rows=table.rows,
                 batches=table.batches, poolings=table.poolings,
                 fwd_ms=table.fwd_ms, bwd_ms=table.bwd_ms,
                 scalar_json=np.array(json.dumps(scalar)))
    return _save
