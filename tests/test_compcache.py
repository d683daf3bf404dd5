"""Persistent-compilation-cache rules (utils.compcache)."""

import os

import jax
import pytest

import cvo_slam_tpu.utils.compcache as cc


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_dir_is_kept(tmp_path, monkeypatch, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert cc.enable_persistent_cache() is True
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    assert cc.enable_persistent_cache() is True      # idempotent
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")


def test_default_dir_is_fixed_under_repo(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cc.enable_persistent_cache() is True
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        repo, ".cache", "jax")


def test_opt_out(monkeypatch, restore_cache_config):
    monkeypatch.setenv("CVO_SLAM_COMPCACHE", "0")
    before = jax.config.jax_compilation_cache_dir
    assert cc.enable_persistent_cache() is False
    assert jax.config.jax_compilation_cache_dir == before
