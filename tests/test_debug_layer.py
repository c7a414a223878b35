"""debug_layer (the D3D12 debug-layer analog) and compilation-cache config."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12_deferred_renderer_tpu.utils.debug import debug_layer, enable_compilation_cache


def test_debug_layer_catches_nan():
    with debug_layer(nans=True, infs=False):
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.asarray(-1.0)).block_until_ready()
    # Restored afterwards: NaN passes silently again.
    out = jnp.log(jnp.asarray(-1.0))
    assert np.isnan(np.asarray(out))


def test_debug_layer_restores_on_exception():
    prev = jax.config.jax_debug_nans
    try:
        with debug_layer():
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    assert jax.config.jax_debug_nans == prev


def test_enable_compilation_cache_sets_config(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is <checkout>/.jax_cache
    (tests/test_dispatch.py covers the variable being set)."""
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prev = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compilation_cache(min_compile_secs=1.0)
        assert path == os.path.join(checkout, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
