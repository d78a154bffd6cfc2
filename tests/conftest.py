"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Sharding tests run against an 8-device virtual CPU backend per the
multi-host test strategy (SURVEY.md §4d).  Numeric-tolerance tests
assume CPU float32.  The checks that need a GPU run on the card as phases
of ``chip_smoke.py``.
"""
import os

# set before JAX initializes; inherited by any subprocesses tests spawn
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    The full suite compiles several hundred XLA CPU programs; keeping them
    all loaded eventually segfaults LLVM's JIT inside
    ``backend_compile_and_load`` (reproducible at the same test ~110
    programs in, regardless of machine load — run standalone the same test
    passes).  Dropping the caches between modules bounds resident JIT code
    at the cost of recompiling the handful of shared solver programs.
    """
    yield
    import jax

    jax.clear_caches()
