"""The shared persistent compile cache helper."""

import jax
import pytest

from c_ofdm.utils import compile_cache


@pytest.fixture(autouse=True)
def _restore_cache_config():
    """The helper sets process-wide options; the rest of the suite keeps
    the ones conftest chose."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_env_dir_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache(2.5) == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.5


def test_repo_dir_when_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.REPO_CACHE_DIR
    assert path.endswith(".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
