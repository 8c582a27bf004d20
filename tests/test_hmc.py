"""End-to-end HMC tests: stability boundary and Stan-wiki MCSE quality gates.

Mirrors ref tests/test_hmc.py:100-264.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as stats

from aehmc_tpu import hmc
from aehmc_tpu.diagnostics import effective_sample_size
from aehmc_tpu.models import mvn, normal
from aehmc_tpu.sampling import sample_loop


def compute_mcse(x):
    ess = np.asarray(effective_sample_size(jnp.asarray(x)[None]))
    std_x = np.std(x, axis=0, ddof=1)
    return np.mean(x, axis=0), std_x / np.sqrt(ess)


def assert_mcse_within_error(samples, loc, scale, rho):
    """Stan-wiki MCSE z-tests on mean / variance / correlation
    (ref tests/test_hmc.py:249-264)."""
    delta_loc = samples - loc
    mean, mcse = compute_mcse(delta_loc)
    p_greater_error = stats.norm.sf(np.abs(mean) / mcse)
    np.testing.assert_array_less(0.01, p_greater_error)

    delta_var = np.square(samples - loc) - scale**2
    mean, mcse = compute_mcse(delta_var)
    p_greater_error = stats.norm.sf(np.abs(mean) / mcse)
    np.testing.assert_array_less(0.01, p_greater_error)

    delta_cor = np.prod(samples - loc, axis=1) / np.prod(scale) - rho
    mean, mcse = compute_mcse(delta_cor)
    p_greater_error = stats.norm.sf(np.abs(mean) / mcse)
    np.testing.assert_array_less(0.01, p_greater_error)


def multivariate_normal_model(dtype=None):
    loc = np.array([0.0, 3.0])
    scale = np.array([1.0, 2.0])
    rho = 0.5
    cov = np.diag(scale**2)
    cov[0, 1] = cov[1, 0] = rho * scale[0] * scale[1]
    return (loc, scale, rho), mvn(loc, cov, dtype)


# The statistical gates run at both f64 (the reference's test policy, ref
# conftest.py:4-10) and f32 (the production accelerator dtype — mirrors the
# reference's float32 sweep hook, ref .github/workflows/test.yml:114-116).
DTYPES = [jnp.float64, jnp.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("step_size, diverges", [(3.9, False), (4.1, True)])
def test_univariate_hmc(step_size, diverges, dtype):
    """On N(1, 2^2) trajectory integration is stable iff eps < 2 sigma
    (ref tests/test_hmc.py:100-155)."""
    logprob_fn = normal(1.0, 2.0)
    kernel = hmc.new_kernel(logprob_fn)
    initial_state = hmc.new_state(jnp.asarray(3.0, dtype), logprob_fn)

    bound = lambda key, state: kernel(  # noqa: E731
        key, state, jnp.asarray(step_size, dtype), jnp.asarray(1.0, dtype), 30
    )
    _, positions, _ = jax.jit(
        lambda key: sample_loop(key, bound, initial_state, 5000)
    )(jax.random.PRNGKey(0))
    assert positions.dtype == dtype  # no silent upcast
    samples = np.asarray(positions)

    if diverges:
        assert np.all(samples == 3.0)
    else:
        assert np.mean(samples[1000:]) == pytest.approx(1.0, rel=2e-1)
        assert np.var(samples[1000:]) == pytest.approx(4.0, rel=2e-1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hmc_mcse(dtype):
    """Stan-wiki sampler-correctness methodology on a correlated 2-D MVN
    (ref tests/test_hmc.py:190-264)."""
    (loc, scale, rho), logprob_fn = multivariate_normal_model(dtype)
    kernel = hmc.new_kernel(logprob_fn)

    rng = np.random.default_rng(seed=0)
    initial_state = hmc.new_state(
        jnp.asarray(rng.standard_normal(2), dtype), logprob_fn
    )
    inverse_mass_matrix = jnp.asarray(scale, dtype)
    bound = lambda key, state: kernel(  # noqa: E731
        key, state, jnp.asarray(1.0, dtype), inverse_mass_matrix, 30
    )
    _, positions, infos = jax.jit(
        lambda key: sample_loop(key, bound, initial_state, 3000)
    )(jax.random.PRNGKey(1))
    samples = np.asarray(positions)[1000:]
    assert_mcse_within_error(samples, loc, scale, rho)
    # acceptance should be healthy with these settings
    assert float(np.mean(np.asarray(infos.acceptance_probability))) > 0.5
