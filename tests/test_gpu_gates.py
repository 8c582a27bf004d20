"""Statistical gates on the GPU, float32: the XLA routes of the front
door recover known posterior moments on the card, and a one-device mesh
equals the unsharded run.  The CPU suite covers the same routes in
float64; these pin what only the card can show (its f32 arithmetic, its
reduction orders, its compiler).

Run on the card with ``python chip_smoke.py`` (phase 3) or
``AEHMC_DEVICE_SUITE=1 python -m pytest -m gpu tests/test_gpu_gates.py``;
elsewhere they skip.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import aehmc_tpu

pytestmark = pytest.mark.gpu

CHAINS, DIM = 256, 8
VAR = np.linspace(0.5, 2.0, DIM).astype(np.float32)


@pytest.fixture(autouse=True)
def _gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")


def _logprob(q):
    return -0.5 * jnp.sum(q * q / jnp.asarray(VAR))


def _q0(seed=0):
    return jax.random.normal(
        jax.random.PRNGKey(seed), (CHAINS, DIM), jnp.float32
    ) * jnp.sqrt(jnp.asarray(VAR))


@pytest.mark.parametrize("algorithm, draws", [
    ("nuts", 400), ("hmc", 400), ("chees", 400), ("meads", 800),
    ("ghmc", 800), ("mala", 1200),
])
def test_pooled_moments(algorithm, draws):
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(1), _logprob, _q0(), draws, 300,
        algorithm=algorithm,
    )
    assert res.positions.dtype == jnp.float32
    assert float(np.mean(res.diagnostics.acceptance_probability)) > 0.5
    assert int(np.sum(res.diagnostics.is_diverging)) == 0
    flat = np.asarray(res.positions)[draws // 4:].reshape(-1, DIM)
    assert np.all(np.abs(flat.mean(axis=0)) < 0.15)
    np.testing.assert_allclose(flat.var(axis=0), VAR, rtol=0.2)


def test_pooled_nuts_deterministic_per_seed():
    run = lambda: aehmc_tpu.sample(  # noqa: E731
        jax.random.PRNGKey(3), _logprob, _q0(2), 100, 100,
    )
    a, b = run(), run()
    np.testing.assert_array_equal(np.asarray(a.positions),
                                  np.asarray(b.positions))


def test_one_device_mesh_matches_unsharded():
    from aehmc_tpu.parallel.mesh import make_mesh

    plain = aehmc_tpu.sample(jax.random.PRNGKey(5), _logprob, _q0(4), 50, 50)
    meshed = aehmc_tpu.sample(jax.random.PRNGKey(5), _logprob, _q0(4), 50,
                              50, mesh=make_mesh(1))
    np.testing.assert_array_equal(np.asarray(plain.positions),
                                  np.asarray(meshed.positions))
    np.testing.assert_array_equal(np.asarray(plain.step_size),
                                  np.asarray(meshed.step_size))


def test_funnel_v_marginal():
    """Neal's funnel through pooled NUTS: v ~ N(0, 3^2) by construction.
    v mixes slowly, so the mean bound catches gross bias and the sd pins
    the scale."""
    from aehmc_tpu.models import neals_funnel

    logprob_fn, _ = neals_funnel(10)
    q0 = 0.1 * jax.random.normal(jax.random.PRNGKey(8), (512, 10),
                                 jnp.float32)
    res = aehmc_tpu.sample(jax.random.PRNGKey(9), logprob_fn, q0, 400, 300,
                           target_acceptance_rate=0.9)
    v = np.asarray(res.positions)[50:, :, 0].ravel()
    assert abs(v.mean()) < 0.8
    assert abs(v.std() - 3.0) < 0.6
