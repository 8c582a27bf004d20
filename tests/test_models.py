"""Correctness of the built-in model library's log-densities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as stats

from aehmc_tpu.models import (
    correlated_mvn,
    eight_schools,
    linear_regression,
    logistic_regression,
    mvn,
    neals_funnel,
    normal,
    std_normal,
)


def test_std_normal_matches_scipy():
    """std_normal omits the additive constant; differences and gradients
    must match the true density exactly."""
    lp = std_normal()
    q = jnp.asarray([0.3, -1.2, 2.0])
    rv = stats.multivariate_normal(np.zeros(3), np.eye(3))
    np.testing.assert_allclose(jax.grad(lp)(q), -np.asarray(q), rtol=1e-12)
    np.testing.assert_allclose(
        float(lp(q)) - float(lp(jnp.zeros(3))),
        rv.logpdf(np.asarray(q)) - rv.logpdf(np.zeros(3)),
        rtol=1e-10,
    )


def test_normal_matches_scipy():
    lp = normal(1.0, 2.0)
    for x in [-1.0, 0.0, 3.5]:
        np.testing.assert_allclose(
            float(lp(jnp.asarray(x))),
            stats.norm.logpdf(x, 1.0, 2.0),
            rtol=1e-10,
        )


def test_mvn_matches_scipy():
    cov = np.array([[2.0, 0.6], [0.6, 1.0]])
    loc = np.array([1.0, -1.0])
    lp = mvn(loc, cov)
    rv = stats.multivariate_normal(loc, cov)
    for seed in range(3):
        q = np.random.default_rng(seed).normal(size=2)
        np.testing.assert_allclose(
            float(lp(jnp.asarray(q))), rv.logpdf(q), rtol=1e-8
        )


def test_correlated_mvn_gradient_at_mode():
    lp = correlated_mvn(dim=25, rho=0.5)
    grad = jax.grad(lp)(jnp.zeros(25))
    np.testing.assert_allclose(np.asarray(grad), 0.0, atol=1e-10)


def test_linear_regression_posterior_peaks_near_truth():
    lp, q0 = linear_regression(num_points=5000)
    # posterior mode close to (w=3, log_sigma=0)
    from scipy.optimize import minimize

    f = lambda q: -float(lp(jnp.asarray(q)))  # noqa: E731
    g = lambda q: -np.asarray(jax.grad(lp)(jnp.asarray(q)))  # noqa: E731
    res = minimize(f, np.zeros(2), jac=g, method="BFGS")
    assert res.x[0] == pytest.approx(3.0, abs=0.1)
    assert np.exp(res.x[1]) == pytest.approx(1.0, abs=0.1)


def test_logistic_regression_gradient_shape_and_finite():
    lp, q0 = logistic_regression(dim=100, num_points=1000)
    value, grad = jax.value_and_grad(lp)(q0)
    assert grad.shape == (100,)
    assert np.isfinite(float(value))
    assert np.all(np.isfinite(np.asarray(grad)))
    # the prior pulls the mode away from zero gradient at origin
    assert float(jnp.linalg.norm(grad)) > 0.1


def test_neals_funnel_scale_structure():
    lp, q0 = neals_funnel(dim=10)
    assert q0.shape == (10,)
    # logprob at v=-5 vs v=+5 with x=0: narrow funnel favors... both finite
    low = float(lp(jnp.asarray([-5.0] + [0.0] * 9)))
    high = float(lp(jnp.asarray([5.0] + [0.0] * 9)))
    assert np.isfinite(low) and np.isfinite(high)
    # conditional on x=0 exactly, smaller v has higher density (x-term dominates)
    assert low > high


def test_eight_schools_finite_and_informative():
    lp, q0 = eight_schools()
    assert q0.shape == (10,)
    value, grad = jax.value_and_grad(lp)(q0 + 0.1)
    assert np.isfinite(float(value))
    assert np.all(np.isfinite(np.asarray(grad)))
    # pulling mu toward the data mean increases the posterior
    better = q0.at[0].set(8.0)
    assert float(lp(better)) > float(lp(q0.at[0].set(-20.0)))


def _np_reference(name):
    """Float64 NumPy log densities (up to a constant) of the built-ins."""
    from aehmc_tpu.models import logistic_regression_data

    if name == "funnel":
        def ref(q):
            v, x = q[0], q[1:]
            return -(0.5 * (v / 3.0) ** 2 + 0.5 * np.sum(x * x) * np.exp(-v)
                     + (q.size - 1) * 0.5 * v)
        return neals_funnel(10)[0], ref, 10
    if name == "eight_schools":
        y = np.asarray([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
        sig = np.asarray([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

        def ref(q):
            mu, lt, tr = q[0], q[1], q[2:]
            theta = mu + np.exp(lt) * tr
            return -(0.5 * (mu / 5) ** 2 + 0.5 * (lt / 5) ** 2 - lt
                     + 0.5 * np.sum(tr * tr)
                     + 0.5 * np.sum((y - theta) ** 2 / sig**2))
        return eight_schools()[0], ref, 10
    if name == "logistic":
        X, y = (np.asarray(a, np.float64)
                for a in logistic_regression_data(6, 50))

        def ref(q):
            logits = X @ q
            return np.sum(y * logits - np.logaddexp(0.0, logits)) - 0.5 * q @ q
        return logistic_regression(dim=6, num_points=50)[0], ref, 6
    return correlated_mvn(3, 0.4), None, 3


@pytest.mark.parametrize(
    "name", ["funnel", "eight_schools", "logistic", "mvn"]
)
def test_logprob_matches_numpy_reference_up_to_constant(name):
    logprob_fn, ref, dim = _np_reference(name)
    qs = np.random.default_rng(0).normal(size=(5, dim)) * 0.5
    got = np.asarray([float(logprob_fn(jnp.asarray(q))) for q in qs])
    if ref is None:  # equicorrelated MVN: the closed-form quadratic form
        cov = np.full((dim, dim), 0.4)
        np.fill_diagonal(cov, 1.0)
        prec = np.linalg.inv(cov)
        want = np.asarray([-0.5 * q @ prec @ q for q in qs])
    else:
        want = np.asarray([ref(q) for q in qs])
    diff = got - want
    np.testing.assert_allclose(diff, diff[0], atol=1e-6)


@pytest.mark.parametrize(
    "name", ["funnel", "eight_schools", "logistic", "mvn"]
)
def test_logprob_gradient_matches_finite_differences(name):
    logprob_fn, _, dim = _np_reference(name)
    q = jnp.asarray(np.random.default_rng(1).normal(size=dim) * 0.5)
    g = np.asarray(jax.grad(logprob_fn)(q))
    h = 1e-6
    fd = np.asarray([
        (float(logprob_fn(q.at[i].add(h))) - float(logprob_fn(q.at[i].add(-h))))
        / (2 * h)
        for i in range(dim)
    ])
    np.testing.assert_allclose(g, fd, rtol=1e-5, atol=1e-6)
