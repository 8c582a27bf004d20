"""Tests of RaveledParamsMap (mirrors ref tests/test_utils.py round-trip and
dtype-preservation checks)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from aehmc_tpu.utils import RaveledParamsMap


def test_ravel_unravel_roundtrip():
    params = {
        "w": np.arange(6, dtype=np.float64).reshape(2, 3),
        "b": np.array(1.5),
        "n": np.array([2.0, 3.0]),
    }
    rp_map = RaveledParamsMap(params)
    flat = rp_map.ravel_params(params)
    assert flat.shape == (9,)
    restored = rp_map.unravel_params(flat)
    for k in params:
        np.testing.assert_array_equal(restored[k], params[k])
        assert restored[k].shape == np.shape(params[k])


def test_dtype_preservation():
    params = {
        "f32": np.ones(3, dtype=np.float32),
        "f64": np.ones(2, dtype=np.float64),
        "i64": np.array([1, 2], dtype=np.int64),
    }
    rp_map = RaveledParamsMap(params)
    flat = rp_map.ravel_params(params)
    restored = rp_map.unravel_params(flat)
    assert restored["f32"].dtype == jnp.float32
    assert restored["f64"].dtype == jnp.float64
    assert restored["i64"].dtype == jnp.int64
    np.testing.assert_array_equal(restored["i64"], [1, 2])


def test_sequence_input_keys_by_index():
    rp_map = RaveledParamsMap([np.zeros(2), np.zeros((2, 2))])
    assert rp_map.size == 6
    flat = rp_map.ravel_params([np.arange(2.0), np.arange(4.0).reshape(2, 2)])
    restored = rp_map.unravel_params(flat)
    np.testing.assert_array_equal(restored[0], [0.0, 1.0])
    np.testing.assert_array_equal(restored[1], [[0.0, 1.0], [2.0, 3.0]])


def test_scalar_params():
    rp_map = RaveledParamsMap({"a": np.array(2.0), "b": np.array(3.0)})
    flat = rp_map.ravel_params({"a": 2.0, "b": 3.0})
    assert flat.shape == (2,)
    restored = rp_map.unravel_params(flat)
    assert restored["a"].shape == ()
    assert float(restored["b"]) == 3.0


def test_logprob_through_map():
    """The intended use: HMC samples a flat vector, the model sees a dict."""
    params = {"w": np.zeros((2,)), "sigma": np.array(1.0)}
    rp_map = RaveledParamsMap(params)

    def logprob_fn(q):
        p = rp_map.unravel_params(q)
        return -0.5 * jnp.sum(p["w"] ** 2) - 0.5 * p["sigma"] ** 2

    import jax

    value, grad = jax.value_and_grad(logprob_fn)(jnp.asarray([1.0, 2.0, 3.0]))
    assert float(value) == -0.5 * (1 + 4) - 0.5 * 9
    np.testing.assert_allclose(grad, [-1.0, -2.0, -3.0])


@pytest.fixture
def _restore_cache_config():
    import jax

    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compilation_cache_follows_the_environment(
    tmp_path, monkeypatch, _restore_cache_config
):
    import jax

    from aehmc_tpu.utils import enable_compilation_cache

    target = tmp_path / "cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert enable_compilation_cache() == str(target)
    assert target.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(target)


def test_compilation_cache_defaults_to_the_checkout(
    monkeypatch, _restore_cache_config
):
    import jax

    from aehmc_tpu.utils import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = enable_compilation_cache()
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
