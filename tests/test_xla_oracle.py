"""The XLA NUTS transition against the float64 NumPy oracle on the models
and regimes the removed kernel tests covered: diagonal Gaussians across
step sizes and depths, dense metrics, per-chain step sizes under ``vmap``,
Neal's funnel and eight schools.  Randomness is externalized
(:func:`aehmc_tpu.nuts.new_externalized_kernel`), so every decision must
agree exactly and positions to float64 round-off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aehmc_tpu import hmc, nuts
from aehmc_tpu.models import eight_schools, neals_funnel
from aehmc_tpu.ops.nuts_oracle import nuts_transition_oracle_generic


def _streams(rng, chains, dim, max_exp):
    p = rng.normal(size=(chains, dim))
    dirs = np.where(rng.uniform(size=(chains, max_exp)) < 0.5, -1.0, 1.0)
    ub = rng.uniform(size=(chains, max_exp))
    ul = rng.uniform(size=(chains, 2**max_exp))
    return p, dirs, ub, ul


def _check(logprob_fn, pot_np, grad_np, q, im, eps, max_exp, seed,
           paired=True, atol=1e-8):
    chains, dim = q.shape
    p, dirs, ub, ul = _streams(np.random.default_rng(seed), chains, dim,
                               max_exp)
    kernel = jax.jit(nuts.new_externalized_kernel(
        logprob_fn, max_num_expansions=max_exp, paired_leaves=paired
    ))
    eps = np.broadcast_to(np.asarray(eps, np.float64), (chains,))
    for i in range(chains):
        state = hmc.new_state(jnp.asarray(q[i]), logprob_fn)
        new, info = kernel(state, jnp.asarray(p[i]), jnp.asarray(dirs[i]),
                           jnp.asarray(ub[i]), jnp.asarray(ul[i]),
                           jnp.asarray(eps[i]), jnp.asarray(im))
        ref = nuts_transition_oracle_generic(
            pot_np, grad_np, q[i], p[i], im, float(eps[i]), dirs[i], ub[i],
            ul[i], max_exp,
        )
        tag = (seed, i)
        assert int(info.num_doublings) == ref["num_doublings"], tag
        assert int(info.num_integration_steps) == (
            ref["num_integration_steps"]), tag
        assert bool(info.is_diverging) == ref["is_diverging"], tag
        assert bool(info.is_turning) == ref["is_turning"], tag
        np.testing.assert_allclose(np.asarray(new.position), ref["position"],
                                   atol=atol)


def _gaussian(seed, dim=6):
    var = np.random.default_rng(100 + seed).uniform(0.5, 2.0, dim)

    def logprob_fn(q):
        return -0.5 * jnp.sum(q * q / jnp.asarray(var))

    return (logprob_fn, lambda q: 0.5 * np.sum(q * q / var),
            lambda q: q / var)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize(
    "eps, max_exp", [(0.3, 4), (0.9, 4), (0.05, 5), (25.0, 4)]
)
def test_gaussian_matches_oracle(eps, max_exp, paired):
    for seed in (0, 1):
        logprob_fn, pot, grad = _gaussian(seed)
        q = np.random.default_rng(seed).normal(size=(8, 6))
        _check(logprob_fn, pot, grad, q, np.ones(6), eps, max_exp, seed,
               paired)


@pytest.mark.parametrize("eps", [0.3, 0.8])
def test_dense_metric_matches_oracle(eps):
    rng = np.random.default_rng(11)
    dim = 6
    A = rng.normal(size=(dim, dim))
    cov = A @ A.T / dim + np.eye(dim)
    prec = np.linalg.inv(cov)

    def logprob_fn(q):
        return -0.5 * q @ jnp.asarray(prec) @ q

    q = rng.normal(size=(8, dim))
    _check(logprob_fn, lambda x: 0.5 * x @ prec @ x, lambda x: prec @ x,
           q, cov, eps, 4, 11)


def test_per_chain_step_sizes_match_oracle():
    """Each chain at its own step size, one batched call under vmap."""
    logprob_fn, pot, grad = _gaussian(5)
    rng = np.random.default_rng(17)
    chains, dim, max_exp = 8, 6, 4
    q = rng.normal(size=(chains, dim))
    eps = rng.uniform(0.05, 1.2, size=chains)
    p, dirs, ub, ul = _streams(rng, chains, dim, max_exp)
    kernel = nuts.new_externalized_kernel(logprob_fn,
                                          max_num_expansions=max_exp)
    states = jax.vmap(lambda x: hmc.new_state(x, logprob_fn))(jnp.asarray(q))
    new, info = jax.jit(jax.vmap(kernel, in_axes=(0, 0, 0, 0, 0, 0, None)))(
        states, jnp.asarray(p), jnp.asarray(dirs), jnp.asarray(ub),
        jnp.asarray(ul), jnp.asarray(eps), jnp.ones(dim),
    )
    for i in range(chains):
        ref = nuts_transition_oracle_generic(
            pot, grad, q[i], p[i], np.ones(dim), float(eps[i]), dirs[i],
            ub[i], ul[i], max_exp,
        )
        assert int(info.num_integration_steps[i]) == (
            ref["num_integration_steps"])
        np.testing.assert_allclose(np.asarray(new.position[i]),
                                   ref["position"], atol=1e-8)


def test_funnel_matches_oracle():
    dim = 10
    logprob_fn, _ = neals_funnel(dim)

    def pot(q):
        v, x = q[0], q[1:]
        return (0.5 * (v / 3.0) ** 2 + 0.5 * np.sum(x * x) * np.exp(-v)
                + (dim - 1) * 0.5 * v)

    def grad(q):
        v, x = q[0], q[1:]
        e = np.exp(-v)
        return np.concatenate([
            [v / 9.0 - 0.5 * np.sum(x * x) * e + (dim - 1) * 0.5], x * e
        ])

    q = np.random.default_rng(3).normal(size=(6, dim)) * 0.5
    _check(logprob_fn, pot, grad, q, np.ones(dim), 0.2, 5, 3, atol=1e-7)


def test_eight_schools_matches_oracle():
    logprob_fn, _ = eight_schools(non_centered=True)
    y = np.asarray([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sig = np.asarray([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

    def pot(q):
        mu, lt, tr = q[0], q[1], q[2:]
        theta = mu + np.exp(lt) * tr
        return (0.5 * (mu / 5) ** 2 + 0.5 * (lt / 5) ** 2 - lt
                + 0.5 * np.sum(tr * tr)
                + 0.5 * np.sum((y - theta) ** 2 / sig**2))

    def grad(q):
        mu, lt, tr = q[0], q[1], q[2:]
        tau = np.exp(lt)
        r = (mu + tau * tr - y) / sig**2
        return np.concatenate([
            [mu / 25 + np.sum(r), lt / 25 - 1 + tau * np.sum(r * tr)],
            tr + tau * r,
        ])

    q = np.random.default_rng(4).normal(size=(6, 10)) * 0.3
    _check(logprob_fn, pot, grad, q, np.ones(10), 0.3, 5, 4, atol=1e-7)
