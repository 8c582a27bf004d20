"""Distributional gates: every sampler's thinned draws must pass a
Kolmogorov-Smirnov test against the exact target CDF.

Stronger than moment checks: KS is sensitive to shape errors (wrong
tails, skew, multimodality artifacts).  MCMC draws are autocorrelated, so
each chain is thinned to near-independence before testing; the significance
level is conservative (p > 1e-3).

Every gate runs at f64 (the reference's test policy, ref conftest.py:4-10)
and f32 (the production accelerator dtype — mirrors the reference's float32 sweep
hook, ref .github/workflows/test.yml:114-116).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as stats

from aehmc_tpu import chees, ghmc, hmc, mala, nuts
from aehmc_tpu.models import normal
from aehmc_tpu.sampling import sample_loop

LOC, SCALE = 1.0, 2.0
DTYPES = [jnp.float64, jnp.float32]


def _ks_ok(samples, thin=20, alpha=1e-3):
    thinned = np.asarray(samples).ravel()[::thin]
    _, p = stats.kstest(thinned, "norm", args=(LOC, SCALE))
    return p > alpha, p


@pytest.mark.parametrize("dtype", DTYPES)
def test_nuts_ks(dtype):
    logprob_fn = normal(LOC, SCALE)
    kernel = nuts.new_kernel(logprob_fn)
    state = nuts.new_state(jnp.asarray(0.0, dtype), logprob_fn)
    bound = lambda k, s: kernel(  # noqa: E731
        k, s, jnp.asarray(1.0, dtype), jnp.asarray(4.0, dtype)
    )
    _, pos, _ = jax.jit(lambda k: sample_loop(k, bound, state, 20_000))(
        jax.random.PRNGKey(0)
    )
    assert pos.dtype == dtype
    ok, p = _ks_ok(np.asarray(pos)[2000:], thin=5)
    assert ok, f"NUTS KS p={p}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_hmc_ks(dtype):
    logprob_fn = normal(LOC, SCALE)
    kernel = hmc.new_kernel(logprob_fn)
    state = hmc.new_state(jnp.asarray(0.0, dtype), logprob_fn)
    bound = lambda k, s: kernel(  # noqa: E731
        k, s, jnp.asarray(0.9, dtype), jnp.asarray(4.0, dtype), 8
    )
    _, pos, _ = jax.jit(lambda k: sample_loop(k, bound, state, 20_000))(
        jax.random.PRNGKey(1)
    )
    assert pos.dtype == dtype
    ok, p = _ks_ok(np.asarray(pos)[2000:], thin=5)
    assert ok, f"HMC KS p={p}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_mala_ks(dtype):
    logprob_fn = normal(LOC, SCALE)
    kernel = mala.new_kernel(logprob_fn)
    state = mala.new_state(jnp.asarray(0.0, dtype), logprob_fn)
    bound = lambda k, s: kernel(  # noqa: E731
        k, s, jnp.asarray(1.5, dtype), jnp.asarray(4.0, dtype)
    )
    _, pos, _ = jax.jit(lambda k: sample_loop(k, bound, state, 60_000))(
        jax.random.PRNGKey(2)
    )
    assert pos.dtype == dtype
    ok, p = _ks_ok(np.asarray(pos)[5000:], thin=25)
    assert ok, f"MALA KS p={p}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_ghmc_ks(dtype):
    logprob_fn = normal(LOC, SCALE)
    kernel = ghmc.new_kernel(logprob_fn)
    state = ghmc.new_state(
        jax.random.PRNGKey(3), jnp.asarray(0.0, dtype), logprob_fn
    )

    def one(carry, k):
        s = carry
        s, _ = kernel(
            k, s, jnp.asarray(1.0, dtype), jnp.asarray(0.9, dtype),
            jnp.asarray(4.0, dtype),
        )
        return s, s.position

    keys = jax.random.split(jax.random.PRNGKey(4), 60_000)
    _, pos = jax.jit(lambda ks: jax.lax.scan(one, state, ks))(keys)
    assert pos.dtype == dtype
    ok, p = _ks_ok(np.asarray(pos)[5000:], thin=25)
    assert ok, f"GHMC KS p={p}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_chees_ks(dtype):
    logprob_fn = normal(LOC, SCALE)
    num_chains = 64
    keys = jax.random.split(jax.random.PRNGKey(5), num_chains)
    qs = jax.vmap(lambda k: jax.random.normal(k, (), dtype))(keys)
    states = jax.vmap(lambda q: hmc.new_state(q, logprob_fn))(qs[:, None])
    # chees operates on (chains, dim); use dim=1
    result = jax.jit(
        lambda k: chees.warmup(
            k, lambda q: normal(LOC, SCALE)(q[0]), states, num_steps=200,
            initial_step_size=0.2,
        )
    )(jax.random.PRNGKey(6))
    _, pos, _ = chees.sample(
        jax.random.PRNGKey(7),
        lambda q: normal(LOC, SCALE)(q[0]),
        result.states,
        800,
        result.step_size,
        result.trajectory_length,
        result.inverse_mass_matrix,
    )
    assert pos.dtype == dtype
    # many chains => thin across draws only lightly
    ok, p = _ks_ok(np.asarray(pos)[200:], thin=7)
    assert ok, f"ChEES KS p={p}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_meads_ks(dtype):
    from aehmc_tpu import meads

    num_chains = 64
    keys = jax.random.split(jax.random.PRNGKey(8), num_chains)
    qs = jax.vmap(lambda k: jax.random.normal(k, (1,), dtype))(keys)
    _, pos, _, _ = jax.jit(
        lambda k: meads.sample(
            k,
            lambda q: normal(LOC, SCALE)(q[0]),
            qs,
            num_samples=800,
            num_warmup=400,
        )
    )(jax.random.PRNGKey(9))
    assert pos.dtype == dtype
    ok, p = _ks_ok(np.asarray(pos)[200:], thin=7)
    assert ok, f"MEADS KS p={p}"
