"""The front door's XLA routes on the models and sizes the removed kernel
tests covered: shapes and sane output for every algorithm on every
built-in model, posterior moments on a diagonal Gaussian, per-chain step
sizes, dense metrics, tree-depth bounds and the adaptation's direction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import aehmc_tpu
from aehmc_tpu.models import (
    correlated_mvn,
    eight_schools,
    logistic_regression,
    neals_funnel,
)

ALGORITHMS = aehmc_tpu.api.ALGORITHMS
VAR = np.asarray([0.5, 2.0, 1.0, 4.0])


def _gauss(q):
    return -0.5 * jnp.sum(q * q / jnp.asarray(VAR))


def _start(chains, dim, seed=0, scale=0.1):
    return scale * jax.random.normal(jax.random.PRNGKey(seed), (chains, dim))


def _model(name):
    if name == "funnel":
        return neals_funnel(10)[0], 10
    if name == "eight_schools":
        return eight_schools()[0], 10
    if name == "logistic":
        return logistic_regression(dim=8, num_points=100)[0], 8
    return correlated_mvn(4, 0.5), 4


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize(
    "model", ["funnel", "eight_schools", "logistic", "mvn"]
)
def test_pooled_route_on_models(model, algorithm):
    logprob_fn, dim = _model(model)
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(1), logprob_fn, _start(16, dim), 20, 40,
        algorithm=algorithm,
    )
    assert res.positions.shape == (20, 16, dim)
    assert np.isfinite(np.asarray(res.positions)).all()
    accept = np.asarray(res.diagnostics.acceptance_probability)
    assert accept.shape == (20, 16)
    assert 0.0 < accept.mean() <= 1.0
    assert np.asarray(res.step_size).size >= 1


@pytest.mark.parametrize("algorithm, draws", [
    ("nuts", 150), ("hmc", 150), ("chees", 200), ("meads", 300),
    ("ghmc", 300), ("mala", 400),
])
def test_pooled_moments_on_gaussian(algorithm, draws):
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(2), _gauss, _start(64, 4, scale=1.0), draws, 200,
        algorithm=algorithm,
    )
    flat = np.asarray(res.positions)[draws // 4:].reshape(-1, 4)
    assert np.all(np.abs(flat.mean(axis=0)) < 0.3)
    np.testing.assert_allclose(flat.var(axis=0), VAR, rtol=0.35)
    assert int(np.sum(np.asarray(res.diagnostics.is_diverging))) == 0


@pytest.mark.parametrize("algorithm", ["nuts", "hmc", "mala", "ghmc"])
def test_independent_chains_route(algorithm):
    """path='xla' with a chain batch warms every chain on its own."""
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(3), _gauss, _start(4, 4), 60, 100,
        path="xla", algorithm=algorithm,
    )
    assert res.positions.shape == (4, 60, 4)
    assert np.isfinite(np.asarray(res.positions)).all()
    assert np.asarray(res.step_size).shape == (4,)


@pytest.mark.parametrize("algorithm", ["nuts", "hmc", "mala", "ghmc"])
def test_per_chain_step_size(algorithm):
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(4), _gauss, _start(8, 4, scale=1.0), 30, 60,
        algorithm=algorithm, per_chain_step_size=True,
    )
    eps = np.asarray(res.step_size)
    assert eps.shape == (8,)
    assert np.isfinite(eps).all() and (eps > 0).all() and eps.std() > 0
    assert np.isfinite(np.asarray(res.positions)).all()


@pytest.mark.parametrize("algorithm", ["nuts", "hmc"])
def test_dense_metric_self_tuning(algorithm):
    """On a correlated MVN the tuned dense inverse mass picks up the
    off-diagonal structure."""
    rho, dim = 0.7, 4
    logprob_fn = correlated_mvn(dim, rho)
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(5), logprob_fn, _start(64, dim, scale=0.5), 100,
        200, algorithm=algorithm, is_mass_matrix_full=True,
    )
    imm = np.asarray(res.inverse_mass_matrix)
    assert imm.shape == (dim, dim)
    assert imm[~np.eye(dim, dtype=bool)].mean() > 0.3 * np.diag(imm).mean()


@pytest.mark.parametrize("max_exp", [2, 3, 4, 6])
def test_nuts_tree_depth_bound(max_exp):
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(6), _gauss, _start(16, 4), 30, 30,
        max_num_expansions=max_exp, initial_step_size=1e-3,
        search_initial_step_size=False,
    )
    leaves = np.asarray(res.diagnostics.num_integration_steps)
    doublings = np.asarray(res.diagnostics.num_doublings)
    assert leaves.max() <= 2**max_exp - 1
    assert doublings.max() <= max_exp


@pytest.mark.parametrize("algorithm", ["nuts", "hmc", "mala", "ghmc"])
def test_lower_target_acceptance_tunes_larger_steps(algorithm):
    def eps_at(target):
        res = aehmc_tpu.sample(
            jax.random.PRNGKey(7), _gauss, _start(32, 4, scale=1.0), 10,
            200, algorithm=algorithm, target_acceptance_rate=target,
        )
        return float(np.asarray(res.step_size))

    assert eps_at(0.6) > eps_at(0.95)


@pytest.mark.parametrize("scale", [0.1, 1.0, 10.0])
def test_chees_metric_follows_scale(scale):
    """ChEES adapts a diagonal metric: the tuned inverse mass tracks the
    posterior variance, which leaves the step size scale-free."""
    def logprob_fn(q):
        return -0.5 * jnp.sum((q / scale) ** 2)

    res = aehmc_tpu.sample(
        jax.random.PRNGKey(8), logprob_fn, _start(64, 4, scale=scale), 10,
        200, algorithm="chees",
    )
    imm = np.asarray(res.inverse_mass_matrix)
    np.testing.assert_allclose(imm, scale**2, rtol=0.7)
    assert 0.05 < float(np.asarray(res.step_size)) < 5.0


@pytest.mark.parametrize("search", [False, True])
def test_pooled_nuts_with_and_without_step_size_search(search):
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(9), _gauss, _start(32, 4, scale=1.0), 40, 150,
        search_initial_step_size=search, initial_step_size=1e-3,
    )
    assert 0.05 < float(np.asarray(res.step_size)) < 3.0
    assert float(np.mean(res.diagnostics.acceptance_probability)) > 0.4


@pytest.mark.parametrize("recompute_every", [1, 4, 8])
def test_meads_recompute_every(recompute_every):
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(10), _gauss, _start(32, 4, scale=1.0), 64, 64,
        algorithm="meads", meads_recompute_every=recompute_every,
    )
    assert res.positions.shape == (64, 32, 4)
    assert np.isfinite(np.asarray(res.positions)).all()
    assert float(np.mean(res.diagnostics.acceptance_probability)) > 0.5


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_collect_positions_off(algorithm):
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(11), _gauss, _start(16, 4), 10, 20,
        algorithm=algorithm, collect_positions=False,
    )
    assert res.positions is None
    assert np.asarray(res.diagnostics.acceptance_probability).shape == (10, 16)
