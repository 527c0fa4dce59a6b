"""Shared fixtures. NOTE: XLA_FLAGS / fake devices are deliberately NOT set
here — smoke tests and benches must see 1 real device. Sharding tests that
need many devices spawn subprocesses with their own XLA_FLAGS."""

import os

import pytest

import repro.core as rc

#: per-test wall-clock cap (seconds), applied when pytest-timeout is
#: installed: a hung launched worker fails its test in seconds instead of
#: wedging scripts/ci.sh. Guarded like hypothesis — without the plugin the
#: suite still collects and runs, just uncapped.
_TIMEOUT_S = float(os.environ.get("REPRO_TEST_TIMEOUT_S", "180"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "launcher: worker-launcher subsystem tests (select with "
        "'-m launcher', skip with '-m \"not launcher\"')")
    config.addinivalue_line(
        "markers",
        "dataflow: worker-to-worker dataflow tests (locality-scheduled "
        "chains, peer blob fetch; select with '-m dataflow')")
    config.addinivalue_line(
        "markers",
        "state: shared-state subsystem tests (versioned KV, CAS/watch; "
        "select with '-m state')")
    config.addinivalue_line(
        "markers",
        "lineage: lineage reconstruction / replication tests (select "
        "with '-m lineage')")
    config.addinivalue_line(
        "markers",
        "asyncio: cooperative-frontend tests (await/async-for surface and "
        "the event-loop backend; select with '-m asyncio')")
    config.addinivalue_line(
        "markers",
        "serving: multi-tenant secure serving tier tests (TLS/token "
        "handshake, driver server, fair-share; select with '-m serving')")
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs a CUDA device and nvcc (the PyTorch port's "
        "kernels); skips without one")


def pytest_collection_modifyitems(config, items):
    if not config.pluginmanager.hasplugin("timeout"):
        return
    cap = pytest.mark.timeout(_TIMEOUT_S)
    for item in items:
        if item.get_closest_marker("timeout") is None:
            item.add_marker(cap)


@pytest.fixture(autouse=True)
def _reset_plan():
    """Every test starts and ends on the default sequential plan."""
    rc.plan("sequential")
    rc.set_session_seed(0)
    rc.state.reset()               # fresh shared-state service per test
    yield
    rc.shutdown()
    rc.plan("sequential")
    rc.state.reset()
