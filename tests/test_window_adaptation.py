"""Warmup integration tests (ref tests/test_hmc.py:13-97): window adaptation
must move the chain, return a stable step size, and recover the target
variance as the inverse mass matrix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aehmc_tpu import nuts, window_adaptation
from aehmc_tpu.models import mvn, normal
from tests.test_hmc import DTYPES


@pytest.mark.parametrize("dtype", DTYPES)
def test_warmup_scalar(dtype):
    """Univariate N(1, 2^2): scalar mass matrix (ref tests/test_hmc.py:13-52).

    Runs at f64 (the reference's test policy) and f32 (the production GPU
    dtype) — the tuned step size and mass matrix must pass the same quality
    gates at both.
    """
    logprob_fn = normal(1.0, 2.0)
    kernel = nuts.new_kernel(logprob_fn)
    initial_state = nuts.new_state(jnp.asarray(3.0, dtype), logprob_fn)

    state, (step_size, inverse_mass_matrix), info = jax.jit(
        lambda key: window_adaptation.run(
            key, kernel, initial_state, num_steps=1000
        )
    )(jax.random.PRNGKey(0))

    assert float(state.position) != 3.0  # the chain has moved
    assert step_size.dtype == dtype
    assert inverse_mass_matrix.dtype == dtype
    assert jnp.ndim(step_size) == 0
    assert float(step_size) != 1.0
    assert 0.1 < float(step_size) < 2.0
    assert jnp.ndim(inverse_mass_matrix) == 0
    assert float(inverse_mass_matrix) == pytest.approx(4.0, rel=1.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_warmup_vector(dtype):
    """Diagonal MVN: diag mass matrix (ref tests/test_hmc.py:55-97)."""
    loc = np.array([0.0, 3.0])
    scale = np.array([1.0, 2.0])
    logprob_fn = mvn(loc, np.diag(scale**2), dtype)
    kernel = nuts.new_kernel(logprob_fn)
    initial_state = nuts.new_state(jnp.asarray([1.0, 1.0], dtype), logprob_fn)

    state, (step_size, inverse_mass_matrix), _ = jax.jit(
        lambda key: window_adaptation.run(
            key, kernel, initial_state, num_steps=1000
        )
    )(jax.random.PRNGKey(0))

    assert np.all(np.asarray(state.position) != np.array([1.0, 1.0]))
    assert jnp.ndim(step_size) == 0
    assert 0.1 < float(step_size) < 2.0
    assert inverse_mass_matrix.ndim == 1
    np.testing.assert_allclose(inverse_mass_matrix, scale**2, rtol=1.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_warmup_full_mass_matrix(dtype):
    """Dense mass matrix recovers the full covariance on a correlated MVN."""
    cov = np.array([[1.0, 0.7], [0.7, 2.0]])
    logprob_fn = mvn(np.zeros(2), cov, dtype)
    kernel = nuts.new_kernel(logprob_fn)
    initial_state = nuts.new_state(jnp.zeros(2, dtype), logprob_fn)

    _, (step_size, inverse_mass_matrix), _ = jax.jit(
        lambda key: window_adaptation.run(
            key,
            kernel,
            initial_state,
            num_steps=1500,
            is_mass_matrix_full=True,
        )
    )(jax.random.PRNGKey(4))

    assert inverse_mass_matrix.shape == (2, 2)
    # off-diagonal sign must be recovered, magnitudes loosely
    assert float(inverse_mass_matrix[0, 1]) > 0.1
    np.testing.assert_allclose(inverse_mass_matrix, cov, rtol=1.0)
    assert 0.1 < float(step_size) < 2.0


def test_final_step_size_is_averaged_iterate():
    """On the last step the returned step size switches to exp(x_avg)
    (ref window_adaptation.py:184-190), not exp(x)."""
    from aehmc_tpu.types import Diagnostics

    init_adapt, update_adapt = window_adaptation.window_adaptation(
        num_steps=25
    )
    state = init_adapt(nuts.new_state(jnp.asarray(0.5), normal(0.0, 1.0)))

    def info(p):
        return Diagnostics(
            acceptance_probability=jnp.asarray(p),
            num_doublings=jnp.asarray(1, jnp.int32),
            is_turning=jnp.asarray(False),
            is_diverging=jnp.asarray(False),
            energy=jnp.asarray(0.0),
            num_integration_steps=jnp.asarray(1, jnp.int32),
        )

    # a few non-final updates drive iterates and iterates_avg apart
    for step in range(5):
        state = update_adapt(
            jnp.asarray(step), state, jnp.asarray(0.5), info(0.2)
        )
    assert float(state.step_size) == pytest.approx(
        float(jnp.exp(state.da_state.iterates))
    )
    assert not np.isclose(
        float(state.da_state.iterates), float(state.da_state.iterates_avg)
    )
    # ... and the LAST step must return exp(iterates_avg)
    final = update_adapt(jnp.asarray(24), state, jnp.asarray(0.5), info(0.2))
    assert float(final.step_size) == pytest.approx(
        float(jnp.exp(final.da_state.iterates_avg))
    )
    assert float(final.step_size) != pytest.approx(
        float(jnp.exp(final.da_state.iterates))
    )
