"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches see
the real single CPU device; only launch/dryrun.py forces 512 devices."""
import jax
import jax.numpy as jnp
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight arch/perf tests — excluded by `make ci-quick` "
        "(-m 'not slow'), run in the nightly full suite")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (a CUDA kernel has no CPU mode); skips "
        "without one")


@pytest.fixture(scope="module", autouse=True)
def _drop_compile_caches():
    """Drop jit/compile caches between test modules.

    The full suite compiles hundreds of XLA programs in one process;
    letting them accumulate has produced hard segfaults inside
    ``backend_compile`` late in the run (CPU backend).  Each module
    recompiles what it needs; cross-module cache hits were never
    load-bearing."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def key():
    return jax.random.key(20260711)


def simplex(key, shape, temp=1.0):
    return jax.nn.softmax(jax.random.normal(key, shape) * temp, axis=-1)
