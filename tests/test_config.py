"""Settings derived from the environment and the device (rdst_tpu/config.py)."""
import os

import pytest

import jax

from rdst_tpu import config


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """A set JAX_COMPILATION_CACHE_DIR is used as it is, and nothing is
    changed in JAX's config."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert config.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_fixed_repo_path(monkeypatch):
    """Without the variable the cache sits at one fixed path inside the
    checkout, the same on every call."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = config.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert config.enable_compile_cache() == path
    assert calls == [("jax_compilation_cache_dir", path)] * 2


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit", [16 << 30, 60 << 30, 80 << 30])
def test_low_mem_threshold_from_device(monkeypatch, limit):
    """An eighth of the allocator's limit."""
    monkeypatch.setattr(config, "low_mem_threshold_bytes", None)
    dev = _Dev({"bytes_limit": limit, "bytes_in_use": 0})
    assert config.low_mem_threshold(dev) == limit // 8


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_low_mem_threshold_without_limit(monkeypatch, stats):
    """Devices that report no limit (the CPU backend) use 2 GiB."""
    monkeypatch.setattr(config, "low_mem_threshold_bytes", None)
    assert config.low_mem_threshold(_Dev(stats)) == 2 << 30


def test_low_mem_threshold_override_and_cpu_default(monkeypatch):
    monkeypatch.setattr(config, "low_mem_threshold_bytes", None)
    assert config.low_mem_threshold() == 2 << 30  # the CPU test backend
    monkeypatch.setattr(config, "low_mem_threshold_bytes", 1)
    dev = _Dev({"bytes_limit": 80 << 30})
    assert config.low_mem_threshold(dev) == 1
