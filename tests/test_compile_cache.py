"""Placement of JAX's persistent compilation cache."""

import jax

from gaussianvi_tpu.utils import compile_cache


def test_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_repo_jax_cache(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.configure_compile_cache()
        repo = compile_cache.Path(__file__).resolve().parents[1]
        assert path == str(repo / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_path_is_fixed(monkeypatch):
    """The path is part of a cache hit: no temp name, pid or time."""
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert (compile_cache.configure_compile_cache()
                == compile_cache.configure_compile_cache())
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
