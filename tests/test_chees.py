"""Tests of ChEES-HMC: adaptation behavior and statistical correctness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aehmc_tpu import chees, hmc
from aehmc_tpu.diagnostics import potential_scale_reduction
from aehmc_tpu.models import mvn, std_normal


def test_halton_low_discrepancy():
    u = np.asarray(jax.vmap(chees.halton)(jnp.arange(256)))
    assert np.all((u > 0) & (u < 1))
    assert len(np.unique(u)) == 256
    # first base-2 van der Corput points: 1/2, 1/4, 3/4, 1/8, ...
    np.testing.assert_allclose(u[:4], [0.5, 0.25, 0.75, 0.125])
    # equidistribution
    assert abs(float(u.mean()) - 0.5) < 0.01


def _init_states(logprob_fn, num_chains, dim, seed=0, scale=1.0):
    keys = jax.random.split(jax.random.PRNGKey(seed), num_chains)
    qs = scale * jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(
        keys
    )
    return jax.vmap(lambda q: hmc.new_state(q, logprob_fn))(qs)


def test_kernel_shared_trajectory_length():
    logprob_fn = std_normal()
    kernel = chees.new_kernel(logprob_fn)
    states = _init_states(logprob_fn, 8, 3)
    new_states, info = kernel(
        jax.random.PRNGKey(1), states, jnp.asarray(0.3), 7, jnp.ones(3)
    )
    assert int(info.num_integration_steps) == 7
    assert info.acceptance_probability.shape == (8,)
    assert new_states.position.shape == (8, 3)
    assert np.all(np.isfinite(np.asarray(new_states.position)))


def test_warmup_adapts_towards_target_acceptance():
    scale = np.array([1.0, 2.0, 0.5, 1.5])
    logprob_fn = mvn(np.zeros(4), np.diag(scale**2))
    states = _init_states(logprob_fn, 64, 4)

    result = jax.jit(
        lambda key: chees.warmup(
            key, logprob_fn, states, num_steps=300, initial_step_size=0.05
        )
    )(jax.random.PRNGKey(2))

    eps = float(result.step_size)
    h = float(result.trajectory_length)
    assert 0.05 < eps < 3.0
    assert h > eps  # trajectory longer than one step
    # mass matrix recovers the marginal variances loosely
    np.testing.assert_allclose(
        np.asarray(result.inverse_mass_matrix), scale**2, rtol=1.0
    )

    # with the tuned parameters the acceptance rate sits near 0.651
    _, _, info = chees.sample(
        jax.random.PRNGKey(3),
        logprob_fn,
        result.states,
        200,
        result.step_size,
        result.trajectory_length,
        result.inverse_mass_matrix,
    )
    mean_accept = float(np.mean(np.asarray(info.acceptance_probability)))
    assert 0.4 < mean_accept < 0.95
    # divergence flags and energies are first-class sample outputs
    assert info.is_diverging.shape == info.acceptance_probability.shape
    assert info.energy.shape == info.acceptance_probability.shape
    assert not bool(np.any(np.asarray(info.is_diverging)))
    assert np.all(np.isfinite(np.asarray(info.energy)))


def test_chees_statistical_correctness():
    """Correlated 2-D MVN: moments within tolerance, R-hat ~ 1."""
    loc = np.array([0.0, 3.0])
    scale = np.array([1.0, 2.0])
    rho = 0.5
    cov = np.diag(scale**2)
    cov[0, 1] = cov[1, 0] = rho * scale[0] * scale[1]
    logprob_fn = mvn(loc, cov)

    num_chains = 64
    states = _init_states(logprob_fn, num_chains, 2)
    result = jax.jit(
        lambda key: chees.warmup(
            key, logprob_fn, states, num_steps=300, initial_step_size=0.1
        )
    )(jax.random.PRNGKey(4))
    _, positions, _ = chees.sample(
        jax.random.PRNGKey(5),
        logprob_fn,
        result.states,
        500,
        result.step_size,
        result.trajectory_length,
        result.inverse_mass_matrix,
    )
    samples = np.asarray(positions)  # (draws, chains, 2)
    chains_first = np.swapaxes(samples, 0, 1)
    rhat = np.asarray(potential_scale_reduction(jnp.asarray(chains_first)))
    assert np.all(np.abs(rhat - 1.0) < 0.1)

    pooled = samples.reshape(-1, 2)
    np.testing.assert_allclose(pooled.mean(axis=0), loc, atol=0.15)
    np.testing.assert_allclose(pooled.var(axis=0), scale**2, rtol=0.2)
    corr = np.corrcoef(pooled.T)[0, 1]
    assert corr == pytest.approx(rho, abs=0.1)
