"""The persistent compile cache's directory rule: JAX_COMPILATION_CACHE_DIR
when set, else the fixed .jax_cache/ at the root of the checkout."""

import os

import jax
import pytest

from l2n.utils import compile_cache

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_checkout_root(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO_ROOT, ".jax_cache")


@pytest.mark.parametrize("value", ["", None])
def test_empty_or_unset_env_uses_default(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    assert compile_cache.cache_dir() == compile_cache.DEFAULT_DIR


def test_env_dir_is_used_and_nothing_else(monkeypatch, tmp_path):
    target = tmp_path / "xla-cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == str(target)
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert target.is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
