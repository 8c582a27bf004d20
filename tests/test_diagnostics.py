"""Tests of split-R-hat / ESS / MCSE against known-truth cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aehmc_tpu.diagnostics import (
    effective_sample_size,
    mcse,
    potential_scale_reduction,
    tail_effective_sample_size,
)


def _iid_chains(seed=0, chains=4, draws=2000, dim=None):
    rng = np.random.default_rng(seed)
    shape = (chains, draws) if dim is None else (chains, draws, dim)
    return rng.normal(size=shape)


def test_rhat_iid_near_one():
    samples = _iid_chains()
    rhat = float(potential_scale_reduction(jnp.asarray(samples)))
    assert abs(rhat - 1.0) < 0.02


def test_rhat_detects_nonconvergence():
    samples = _iid_chains()
    samples[0] += 10.0  # one chain stuck elsewhere
    rhat = float(potential_scale_reduction(jnp.asarray(samples)))
    assert rhat > 2.0


def test_rhat_detects_trend_within_chain():
    """Split-R-hat catches a trend even with identical chains."""
    draws = 2000
    trend = np.linspace(0.0, 5.0, draws)
    samples = _iid_chains() + trend[None, :]
    rhat = float(potential_scale_reduction(jnp.asarray(samples)))
    assert rhat > 1.2


def test_ess_iid_close_to_n():
    samples = _iid_chains(chains=4, draws=4000)
    n = samples.shape[0] * samples.shape[1]
    ess = float(effective_sample_size(jnp.asarray(samples)))
    assert 0.75 * n < ess < 1.35 * n


def test_ess_ar1_matches_theory():
    """AR(1) with coefficient phi has ESS/N = (1-phi)/(1+phi)."""
    rng = np.random.default_rng(3)
    phi = 0.9
    chains, draws = 4, 20000
    x = np.zeros((chains, draws))
    eps = rng.normal(size=(chains, draws)) * np.sqrt(1 - phi**2)
    for t in range(1, draws):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    n = chains * draws
    expected = n * (1 - phi) / (1 + phi)
    ess = float(effective_sample_size(jnp.asarray(x)))
    assert ess == pytest.approx(expected, rel=0.3)


def test_ess_vectorized_over_dims():
    samples = _iid_chains(dim=3)
    ess = effective_sample_size(jnp.asarray(samples))
    assert ess.shape == (3,)
    assert np.all(np.asarray(ess) > 1000)


def test_rank_normalized_variants_run():
    samples = _iid_chains(chains=4, draws=1000)
    r = float(
        potential_scale_reduction(jnp.asarray(samples), rank_normalized=True)
    )
    assert abs(r - 1.0) < 0.05
    e = float(effective_sample_size(jnp.asarray(samples), rank_normalized=True))
    assert e > 1000


def test_tail_ess_iid_close_to_n():
    samples = _iid_chains(chains=4, draws=4000)
    n = samples.shape[0] * samples.shape[1]
    tess = float(tail_effective_sample_size(jnp.asarray(samples)))
    assert 0.5 * n < tess < 1.5 * n


def test_tail_ess_detects_sticky_tails():
    """An AR(1) chain has correlated tail excursions: tail ESS << N."""
    rng = np.random.default_rng(7)
    phi = 0.95
    chains, draws = 4, 8000
    x = np.zeros((chains, draws))
    eps = rng.normal(size=(chains, draws)) * np.sqrt(1 - phi**2)
    for t in range(1, draws):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    n = chains * draws
    tess = float(tail_effective_sample_size(jnp.asarray(x)))
    assert tess < 0.25 * n


def test_tail_ess_vectorized_over_dims():
    samples = _iid_chains(dim=3)
    tess = tail_effective_sample_size(jnp.asarray(samples))
    assert tess.shape == (3,)
    assert np.all(np.asarray(tess) > 500)


def test_bulk_ess_default_is_rank_normalized():
    """Heavy-tailed draws: classic ESS is dominated by outliers, the
    rank-normalized default is stable. They must differ on Cauchy data."""
    rng = np.random.default_rng(11)
    samples = rng.standard_cauchy(size=(4, 2000))
    bulk = float(effective_sample_size(jnp.asarray(samples)))
    classic = float(
        effective_sample_size(jnp.asarray(samples), rank_normalized=False)
    )
    n = 4 * 2000
    assert 0.5 * n < bulk < 1.5 * n
    assert bulk != classic


def test_mcse_shrinks_with_n():
    small = _iid_chains(chains=1, draws=500)
    large = _iid_chains(chains=1, draws=50000)
    se_small, _ = mcse(jnp.asarray(small))
    se_large, _ = mcse(jnp.asarray(large))
    assert float(se_large) < float(se_small)
    # iid normal: MCSE ~ 1/sqrt(N)
    assert float(se_large) == pytest.approx(1.0 / np.sqrt(50000), rel=0.5)


def test_diagnostics_jit_compatible():
    samples = jnp.asarray(_iid_chains(chains=2, draws=512))
    r = jax.jit(potential_scale_reduction)(samples)
    e = jax.jit(effective_sample_size)(samples)
    assert np.isfinite(float(r)) and np.isfinite(float(e))


def test_summary_columns():
    """summary() reports calibrated columns on known Gaussian chains."""
    from aehmc_tpu.diagnostics import summary

    rng = np.random.default_rng(0)
    samples = jnp.asarray(rng.normal(1.0, 2.0, size=(4, 2000, 3)))
    s = jax.jit(summary)(samples)
    np.testing.assert_allclose(np.asarray(s["mean"]), 1.0, atol=0.15)
    np.testing.assert_allclose(np.asarray(s["sd"]), 2.0, atol=0.15)
    np.testing.assert_allclose(np.asarray(s["median"]), 1.0, atol=0.2)
    np.testing.assert_allclose(
        np.asarray(s["q05"]), 1.0 - 2.0 * 1.645, atol=0.3
    )
    np.testing.assert_allclose(np.asarray(s["r_hat"]), 1.0, atol=0.01)
    assert np.all(np.asarray(s["ess_bulk"]) > 4000)  # iid draws
    assert np.all(np.asarray(s["ess_tail"]) > 2000)
    assert s["mean"].shape == (3,)


def test_to_inference_data_dict_layouts():
    """The arviz bridge handles both driver layouts and carries stats."""
    from aehmc_tpu.diagnostics import to_inference_data_dict
    from aehmc_tpu.models import std_normal
    from aehmc_tpu.parallel import sample_sharded

    res = sample_sharded(
        jax.random.PRNGKey(0), std_normal(), jnp.zeros((8, 2)),
        num_samples=20, num_warmup=30,
    )
    d = to_inference_data_dict(res.positions, res.diagnostics)
    assert d["posterior"]["theta_0"].shape == (8, 20)  # (chain, draw)
    assert d["sample_stats"]["diverging"].shape == (8, 20)
    assert d["sample_stats"]["tree_depth"].dtype.kind in "iu"

    # (chains, draws, dim) layout (sample_chains): draw_axis=1
    pos = np.moveaxis(np.asarray(res.positions), 0, 1)
    d2 = to_inference_data_dict(pos, None, draw_axis=1)
    np.testing.assert_array_equal(
        d2["posterior"]["theta_1"], d["posterior"]["theta_1"]
    )

    # single chain (draws, dim)
    d3 = to_inference_data_dict(np.asarray(res.positions)[:, 0, :])
    assert d3["posterior"]["theta_0"].shape == (1, 20)


def test_rank_normalize_finite_beyond_f32_quantile_resolution():
    """Once the pooled draw count passes ~2^23, the direct upper-tail
    Blom quantile sits within f32 eps of 1.0 and can round to exactly
    1.0 (backend-dependent), sending norm.ppf to +inf and NaN-poisoning
    the dimension's bulk ESS (observed on an accelerator at 10k chains x 800
    draws).  The mirrored-rank evaluation must stay finite and the ESS
    positive at any size."""
    from aehmc_tpu.diagnostics import _rank_normalize

    c, n = 4, (2**23 + 256) // 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(c, n, 1)).astype(np.float32)
    z = np.asarray(_rank_normalize(jnp.asarray(x)))
    assert np.isfinite(z).all()
    # extreme scores land near +-ppf(1/N) and stay symmetric
    assert 5.0 < np.abs(z).max() < 7.0
    np.testing.assert_allclose(z.max(), -z.min(), rtol=1e-5)
    ess = np.asarray(effective_sample_size(jnp.asarray(x)))
    assert ess > 0.25 * c * n  # iid draws: ESS is a large fraction of N
