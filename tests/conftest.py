"""Test configuration: the CPU tests run on a simulated 8-device CPU mesh
(the tier-1 command runs them with JAX_PLATFORMS=cpu); tests marked
``gpu`` need the card and skip elsewhere (README, "Tests").  Unit tests
validate join semantics against numpy oracles, mirroring the reference's
`make check` property-test strategy (reference: tests/Makefile.am,
tests/check_*.c).
"""

import os

# XLA:CPU's C++ compile of the big unrolled programs overflows the default
# 8 MB main-thread stack (segfault inside backend_compile_and_load during
# test_joins' m-pass compiles; depth varies with in-process compile
# history — 64 MB was still not always enough).  Raise the soft limit to
# 1 GiB here so the suite is robust regardless of the invoking shell's
# ulimit; the main-thread stack only grows on demand, so this costs
# nothing when unused.
import resource

_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
_want = 1 << 30
if _soft != resource.RLIM_INFINITY and _soft < _want:
    try:
        resource.setrlimit(resource.RLIMIT_STACK, (
            _want if _hard == resource.RLIM_INFINITY or _hard >= _want
            else _hard, _hard))
    except (ValueError, OSError):
        pass  # best effort: the shell ulimit path still applies

# eight virtual CPU devices for the distributed tests; read when the CPU
# backend starts, so set before jax is imported
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA:CPU segfaults inside backend_compile_and_load once enough
    programs have been compiled in one process (reproduced: the full
    suite crashes at test_joins' first m-pass compile, yet EITHER half
    of the preceding files + test_joins passes — the trigger is purely
    cumulative, not any specific test).  Dropping executable references
    between modules lets LLVM JIT memory be reclaimed and keeps the
    one-process `pytest tests/` invocation robust."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    # seeded but logged, like the reference's seeded property tests
    seed = int(os.environ.get("SMJ_TEST_SEED", np.random.randint(0, 2**31 - 1)))
    print(f"[test rng seed = {seed}]")
    return np.random.default_rng(seed)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided here, when the
    test runs — never while modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
