"""End-to-end hierarchical-model tests (8-schools, funnel) — the geometry
that stresses adaptation and tree depth (BASELINE.md config 4)."""

import jax
import jax.numpy as jnp
import numpy as np

from aehmc_tpu.diagnostics import potential_scale_reduction
from aehmc_tpu.models import eight_schools, neals_funnel
from aehmc_tpu.parallel import sample_sharded


def test_eight_schools_posterior():
    """Non-centered 8-schools: pooled warmup + sampling across 16 chains
    recovers the known posterior structure."""
    logprob_fn, q0 = eight_schools(non_centered=True)
    num_chains = 16
    init = jnp.tile(q0, (num_chains, 1)) + 0.1 * jax.random.normal(
        jax.random.PRNGKey(0), (num_chains, 10), jnp.float64
    )
    result = sample_sharded(
        jax.random.PRNGKey(1),
        logprob_fn,
        init,
        num_samples=1500,
        num_warmup=500,
        target_acceptance_rate=0.9,
    )
    samples = np.asarray(result.positions)  # (draws, chains, 10)
    chains_first = np.swapaxes(samples, 0, 1)
    rhat = np.asarray(
        potential_scale_reduction(jnp.asarray(chains_first))
    )
    assert np.all(rhat < 1.1)

    pooled = samples.reshape(-1, 10)
    mu = pooled[:, 0]
    tau = np.exp(pooled[:, 1])
    # Known posterior summaries for 8-schools (e.g. Stan manual): the
    # population mean sits around 6-10 with wide spread; tau is small-ish.
    assert 2.0 < mu.mean() < 12.0
    assert mu.std() > 2.0
    assert 1.0 < np.median(tau) < 15.0
    # divergences should be rare in the non-centered parameterization
    div_rate = float(np.mean(np.asarray(result.diagnostics.is_diverging)))
    assert div_rate < 0.02


def test_funnel_wide_v_marginal():
    """The funnel's v-marginal is N(0, 3^2); with a high acceptance target
    the sampler must cover at least the bulk (|v| < 2 sigma both sides)."""
    logprob_fn, q0 = neals_funnel(dim=5)
    num_chains = 16
    init = jnp.tile(q0, (num_chains, 1)) + 0.1 * jax.random.normal(
        jax.random.PRNGKey(2), (num_chains, 5), jnp.float64
    )
    result = sample_sharded(
        jax.random.PRNGKey(3),
        logprob_fn,
        init,
        num_samples=2000,
        num_warmup=800,
        target_acceptance_rate=0.95,
    )
    v = np.asarray(result.positions)[..., 0].ravel()
    # full coverage of the neck is a known hard problem (centered funnel);
    # require bulk coverage and approximate symmetry
    assert v.min() < -4.0 and v.max() > 4.0
    assert abs(np.mean(v)) < 1.0
    assert np.std(v) > 2.0
