"""Differential tests: the GENERIC XLA NUTS path vs the NumPy oracle.

These tests point the oracle (:mod:`aehmc_tpu.ops.nuts_oracle`) at the
production path —
``trajectory.dynamic_integration`` (+ paired variant) composed by
``nuts.new_externalized_kernel``, which takes every random input (momentum,
directions, biased-resample uniforms, per-leaf uniforms) as arguments.  Both
sides run float64, so every decision — doubling counts, leaf counts,
divergence/turning flags, acceptance statistics — must agree exactly and
positions to f64 round-off, across benign, deep-tree, turny and divergent
regimes (the reference's regime-coverage idea, ref
tests/test_trajectory.py:144-208, taken to full-transition granularity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aehmc_tpu import hmc, nuts
from aehmc_tpu.ops.nuts_oracle import (
    _logistic_grad,
    _logistic_potential,
    nuts_transition_oracle,
)


def _make_logprob(X, y):
    Xj = jnp.asarray(X)
    yj = jnp.asarray(y)

    def logprob_fn(w):
        logits = Xj @ w
        return jnp.sum(yj * logits - jax.nn.softplus(logits)) - 0.5 * jnp.sum(
            jnp.square(w)
        )

    return logprob_fn


def _run_case(seed, eps, max_exp, paired, chains=6, dim=8, n_points=32,
              scale=0.5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_points, dim)) / np.sqrt(dim)
    y = (rng.uniform(size=n_points) < 0.5).astype(np.float64)
    im = np.ones(dim)
    q = rng.normal(size=(chains, dim)) * scale
    p = rng.normal(size=(chains, dim))
    dirs = np.where(rng.uniform(size=(chains, max_exp)) < 0.5, -1.0, 1.0)
    ub = rng.uniform(size=(chains, max_exp))
    ul = rng.uniform(size=(chains, 2**max_exp))

    logprob_fn = _make_logprob(X, y)
    kernel = nuts.new_externalized_kernel(
        logprob_fn, max_num_expansions=max_exp, paired_leaves=paired
    )
    jitted = jax.jit(kernel)

    for i in range(chains):
        state = hmc.new_state(jnp.asarray(q[i]), logprob_fn)
        new_state, info = jitted(
            state,
            jnp.asarray(p[i]),
            jnp.asarray(dirs[i]),
            jnp.asarray(ub[i]),
            jnp.asarray(ul[i]),
            jnp.asarray(eps, jnp.float64),
            jnp.asarray(im),
        )
        ref = nuts_transition_oracle(
            q[i], p[i], X, y, im, eps, dirs[i], ub[i], ul[i], max_exp
        )
        tag = (seed, i, paired)
        assert int(info.num_doublings) == ref["num_doublings"], tag
        assert int(info.num_integration_steps) == ref["num_integration_steps"], tag
        assert bool(info.is_diverging) == ref["is_diverging"], tag
        assert bool(info.is_turning) == ref["is_turning"], tag
        np.testing.assert_allclose(
            np.asarray(new_state.position), ref["position"], atol=1e-8
        )
        assert float(info.acceptance_probability) == pytest.approx(
            ref["acceptance_probability"], abs=1e-8
        )
        # cross-check the oracle's potential/grad agree with the JAX model
        np.testing.assert_allclose(
            float(new_state.potential_energy),
            _logistic_potential(np.asarray(new_state.position), X, y, 1.0),
            atol=1e-8,
        )
        np.testing.assert_allclose(
            np.asarray(new_state.potential_energy_grad),
            _logistic_grad(np.asarray(new_state.position), X, y, 1.0),
            atol=1e-8,
        )


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize(
    "name, eps, max_exp, scale",
    [
        ("moderate", 0.25, 4, 0.5),
        ("deep", 0.05, 5, 0.5),
        ("turny", 0.8, 4, 0.5),
        ("divergent", 50.0, 4, 2.0),
        ("heterogeneous", 0.5, 5, 1.5),
    ],
)
def test_generic_nuts_matches_oracle(name, eps, max_exp, scale, paired):
    for seed in (0, 1):
        _run_case(seed, eps, max_exp, paired, scale=scale)
