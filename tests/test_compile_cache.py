"""Persistent compile cache location: JAX's own variable wins, else one
fixed directory in the repository."""

import jax
import pytest

from cube_slam_wu_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_set_sets_nothing(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_env_var_unset_uses_repo_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(compile_cache.DEFAULT_DIR)
    assert jax.config.jax_compilation_cache_dir == got
    assert compile_cache.DEFAULT_DIR.name == ".jax_cache"
    assert (compile_cache.DEFAULT_DIR.parent / "pyproject.toml").exists()
