"""Shared fixtures and suite-wide markers.

Fast lane: the dry-run lowering and model-family smoke tests each take
>1 min on a CPU container; they are auto-marked ``slow`` below, so

    pytest -m "not slow"          # fast lane (~seconds per module)
    pytest                        # full tier-1 suite

(or use scripts/run_tier1.sh, which also pins PYTHONPATH=src).

NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see
the single real CPU device; only launch/dryrun.py (and the dedicated
dry-run subprocess tests) use 512 placeholder devices.
"""

import jax
import pytest

SLOW_MODULES = ("test_dryrun", "test_models_smoke")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: >1-min tests (dry-run lowering, model-family "
        'smoke); deselect with -m "not slow"')
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the PyTorch port's kernels); "
        "skips with a reason where none is present")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
