"""Keeps a long test process under the kernel's memory-map limit.

Every program XLA compiles for the CPU holds a few memory mappings until
its cache entry is dropped.  ``tests/conftest.py`` drops the caches
between test modules, but one module can compile enough on its own to
reach ``vm.max_map_count``, and XLA then dies with a segmentation fault
inside ``backend_compile``.  After each test this hook drops the caches
once the process holds more than a quarter of the limit; below that it
does nothing, so tests that share compiled programs keep sharing them.
"""
import gc
import sys

import pytest

_MAPS = "/proc/self/maps"


def _map_limit():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


def _n_maps():
    with open(_MAPS, "rb") as f:
        return sum(1 for _ in f)


_LIMIT = _map_limit()


@pytest.fixture(autouse=True)
def _drop_compile_caches_near_map_limit():
    yield
    jax = sys.modules.get("jax")
    if jax is None or _LIMIT is None:
        return
    if _n_maps() > _LIMIT // 4:
        jax.clear_caches()
        gc.collect()
