"""Sharded vs unsharded on the pooled route, for every algorithm: the
chain axis split over 8 or 4 virtual devices must reproduce the run on
one device (pooled reductions use fixed-tree orders that never observe
the device layout), with tuned parameters and draws to float64
round-off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import aehmc_tpu
from aehmc_tpu.parallel.mesh import make_mesh

VAR = np.asarray([0.5, 2.0, 1.0, 4.0])
CHAINS = 32


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


def _gauss(q):
    return -0.5 * jnp.sum(q * q / jnp.asarray(VAR))


def _run(algorithm, mesh, **kwargs):
    q0 = jax.random.normal(jax.random.PRNGKey(0), (CHAINS, 4))
    return aehmc_tpu.sample(
        jax.random.PRNGKey(1), _gauss, q0, 20, 40, algorithm=algorithm,
        mesh=mesh, **kwargs,
    )


def _agree(a, b):
    np.testing.assert_allclose(np.asarray(a.step_size),
                               np.asarray(b.step_size), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(a.inverse_mass_matrix),
                               np.asarray(b.inverse_mass_matrix), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(a.positions),
                               np.asarray(b.positions), rtol=1e-7,
                               atol=1e-9)


@pytest.mark.parametrize("devices", [8, 4])
@pytest.mark.parametrize("algorithm", aehmc_tpu.api.ALGORITHMS)
def test_sharded_matches_one_device(algorithm, devices):
    _agree(_run(algorithm, make_mesh(1)), _run(algorithm, make_mesh(devices)))


@pytest.mark.parametrize("algorithm", ["nuts", "mala"])
def test_sharded_per_chain_step_size(algorithm):
    one = _run(algorithm, make_mesh(1), per_chain_step_size=True)
    many = _run(algorithm, make_mesh(8), per_chain_step_size=True)
    assert np.asarray(many.step_size).shape == (CHAINS,)
    _agree(one, many)
