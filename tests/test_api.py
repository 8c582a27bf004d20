"""The front door: aehmc_tpu.sample dispatches every algorithm across the
XLA / pooled paths and returns one SampleResult shape.

Statistical quality of each underlying driver is tested in its own
module (test_sampling / test_parallel / test_chees / test_meads /
test_xla_routes); here we pin the routing, the argument contracts, and
that every route produces finite draws that move."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import aehmc_tpu
from aehmc_tpu.sampling import SampleResult

VAR = np.asarray([0.5, 2.0, 1.0, 4.0], np.float32)


def logprob_fn(q):
    return -0.5 * jnp.sum(q * q / VAR)


def _chain_batch(chains=8, dim=4, seed=0):
    return jax.random.normal(
        jax.random.PRNGKey(seed), (chains, dim), jnp.float32
    ) * jnp.sqrt(jnp.asarray(VAR))


def test_single_chain_auto_routes_to_xla():
    out = aehmc_tpu.sample(
        jax.random.PRNGKey(0), logprob_fn, jnp.zeros(4),
        num_samples=50, num_warmup=80,
    )
    assert isinstance(out, SampleResult)
    assert out.positions.shape == (50, 4)
    assert np.isfinite(np.asarray(out.positions)).all()
    assert float(jnp.std(out.positions[:, 0])) > 0.0


@pytest.mark.parametrize("algorithm", ["nuts", "hmc", "mala", "ghmc"])
def test_single_chain_algorithms(algorithm):
    out = aehmc_tpu.sample(
        jax.random.PRNGKey(1), logprob_fn, jnp.zeros(4),
        num_samples=30, num_warmup=60, algorithm=algorithm,
    )
    assert out.positions.shape == (30, 4)
    assert np.isfinite(np.asarray(out.positions)).all()


@pytest.mark.parametrize("algorithm", ["nuts", "chees", "meads"])
def test_chain_batch_auto_routes_to_pooled(algorithm):
    q0 = _chain_batch()
    out = aehmc_tpu.sample(
        jax.random.PRNGKey(2), logprob_fn, q0,
        num_samples=40, num_warmup=60, algorithm=algorithm,
    )
    assert isinstance(out, SampleResult)
    assert out.positions.shape == (40, 8, 4)
    assert np.isfinite(np.asarray(out.positions)).all()


def test_ensemble_algorithms_reject_single_chain():
    with pytest.raises(ValueError, match="chain-ensemble"):
        aehmc_tpu.sample(
            jax.random.PRNGKey(0), logprob_fn, jnp.zeros(4),
            algorithm="chees",
        )


def test_unknown_algorithm_and_path():
    with pytest.raises(ValueError, match="algorithm"):
        aehmc_tpu.sample(
            jax.random.PRNGKey(0), logprob_fn, jnp.zeros(4),
            algorithm="rwmh",
        )
    with pytest.raises(ValueError, match="path"):
        aehmc_tpu.sample(
            jax.random.PRNGKey(0), logprob_fn, jnp.zeros(4),
            path="gpu",
        )


def test_xla_independent_chains_path():
    q0 = _chain_batch()
    out = aehmc_tpu.sample(
        jax.random.PRNGKey(6), logprob_fn, q0,
        num_samples=25, num_warmup=50, path="xla",
    )
    # independent chains stack (chains, draws, dim) — sampling.sample_chains
    assert out.positions.shape == (8, 25, 4)
    assert np.isfinite(np.asarray(out.positions)).all()


@pytest.mark.parametrize("algorithm", aehmc_tpu.api.ALGORITHMS)
def test_kernel_path_is_gone(algorithm):
    """The hand-written kernel route lost its H100 A/B and was removed:
    path='fused' is refused with a message naming the measured paths."""
    with pytest.raises(ValueError, match="no kernel route"):
        aehmc_tpu.sample(
            jax.random.PRNGKey(0), logprob_fn, _chain_batch(),
            num_samples=4, num_warmup=4, algorithm=algorithm, path="fused",
        )
