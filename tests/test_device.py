"""Device-facing choices that the CPU can check: where the compile cache
goes, which wire mode the hash exchange takes on each backend, the
benchmark's peak table, and the out-of-core budget's source."""

import pytest

import bench
from tiflash_jax.exchange.shuffle import wire_mode
from tiflash_jax.runtime import device
from tiflash_jax.runtime.memory import (
    OUTOFCORE_BUDGET_FRACTION, default_outofcore_budget)


def test_compile_cache_in_the_checkout_when_env_unset():
    path = device.compile_cache_dir({})
    assert path == str(device.REPO_ROOT / ".jax_cache")
    assert (device.REPO_ROOT / "tiflash_jax").is_dir()


def test_compile_cache_left_to_jax_when_env_set(monkeypatch):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert device.compile_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("backend,mode", [("gpu", "ragged"), ("cpu", "padded"),
                                          ("other", "padded")])
def test_exchange_wire_mode_by_backend(backend, mode):
    assert wire_mode(backend) == mode


def test_bench_peak_lookup():
    assert bench.peak_hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError, match="no peak memory bandwidth"):
        bench.peak_hbm_bandwidth("cpu")


def test_outofcore_budget_on_cpu_is_a_share_of_host_memory():
    import os

    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert default_outofcore_budget() == int(host * OUTOFCORE_BUDGET_FRACTION)
