"""Test configuration: run all tests on a virtual 8-device CPU mesh with
float64 enabled (the exact-value regression tests assert 1e-7..1e-13
agreement with hand-derived numbers, which requires double precision --
available on the CPU backend).

Tests marked ``gpu`` need the card and skip elsewhere; on a machine with one,
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` runs them.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# PYPMC_TEST_NPROC=2 mode (the reference's `mpirun -n 2` full-suite
# re-run, Makefile:101-104): _testenv_reexec spawned TWO pytest processes;
# join them into one jax.distributed runtime (4 local devices each -> the
# same 8-device global mesh as the single-process suite, spanning a real
# process boundary).
_PROC_ID = os.environ.get("PYPMC_TEST_PROC_ID")
if _PROC_ID is not None:
    jax.distributed.initialize(
        coordinator_address=os.environ["PYPMC_TEST_COORD"],
        num_processes=2,
        process_id=int(_PROC_ID),
    )

jax.config.update("jax_enable_x64", True)

import pytest

# Tests that cannot run under the 2-process runtime: they spawn their own
# process groups (port/runtime conflicts) or materialize particle-sharded
# global arrays on the host (non-addressable across processes).  Curated,
# not inferred -- additions must state why.
_MULTIPROC_SKIP_FILES = {
    # spawns its own 2-process jax.distributed scenarios
    "test_distributed.py": "spawns its own jax.distributed process group",
}


def pytest_collection_modifyitems(config, items):
    if _PROC_ID is None:
        return
    for item in items:
        fname = item.nodeid.split("::")[0].rsplit("/", 1)[-1]
        reason = _MULTIPROC_SKIP_FILES.get(fname)
        if reason is None and item.get_closest_marker("single_process"):
            reason = item.get_closest_marker("single_process").kwargs.get(
                "reason", "materializes non-addressable sharded arrays")
        if reason:
            item.add_marker(pytest.mark.skip(
                reason="2-process suite mode: " + reason))
