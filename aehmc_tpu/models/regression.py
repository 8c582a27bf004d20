"""Regression posteriors (BASELINE.md configs 2 and 5).

The data term of both models is a matvec over the dataset; batched over
thousands of chains it becomes one large matrix product, which is where the
throughput benchmark spends its FLOPs.
"""

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def linear_regression(
    num_points: int = 10_000, true_scale: float = 1.0, seed: int = 8927
) -> Tuple[Callable, jax.Array]:
    """1-D linear regression posterior over (weight, log_sigma).

    Mirrors the reference's benchmark notebook model
    (ref examples/LinearRegression.ipynb cells 4-11): 10k data points, normal
    prior on the weight, Gamma noise scale sampled in log space.

    Returns ``(logprob_fn, example_position)``; the position is the flat
    vector ``[weight, log_sigma]``.
    """
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, size=num_points)
    true_w = 3.0
    y = true_w * X + rng.normal(0.0, true_scale, size=num_points)
    X = jnp.asarray(X)
    y = jnp.asarray(y)

    def logprob_fn(q):
        w, log_sigma = q[0], q[1]
        sigma = jnp.exp(log_sigma)
        # Priors: w ~ N(0, 10); sigma ~ Gamma(2, 2) with log-transform jacobian.
        lp = -0.5 * (w / 10.0) ** 2
        lp = lp + 2.0 * log_sigma - 2.0 * sigma  # Gamma(2, rate=2) + jacobian
        resid = y - w * X
        lp = lp - num_points * log_sigma - 0.5 * jnp.sum(
            jnp.square(resid)
        ) / jnp.square(sigma)
        return lp

    example_position = jnp.asarray([0.0, 0.0])
    return logprob_fn, example_position


def logistic_regression_data(
    dim: int = 100, num_points: int = 1_000, seed: int = 42
) -> Tuple[jax.Array, jax.Array]:
    """The synthetic (X, y) dataset behind :func:`logistic_regression` —
    exposed so benchmarks and references operate on the same posterior."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, size=(num_points, dim)) / np.sqrt(dim)
    true_w = rng.normal(0.0, 1.0, size=dim)
    logits = X @ true_w
    y = (rng.uniform(size=num_points) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float32
    )
    return jnp.asarray(X, dtype=jnp.float32), jnp.asarray(y, dtype=jnp.float32)


def logistic_regression(
    dim: int = 100, num_points: int = 1_000, seed: int = 42
) -> Tuple[Callable, jax.Array]:
    """Bayesian logistic regression in ``dim`` dimensions.

    BASELINE.md config 5: 10k chains on a 100-d posterior.  The per-chain
    gradient is ``X^T (y - sigmoid(X w))``; vmapped over chains this is two
    ``(chains, points) x (points, dim)`` matrix products.
    """
    X, y = logistic_regression_data(dim, num_points, seed)

    def logprob_fn(w):
        logits = X @ w
        # Bernoulli log-likelihood via the numerically-stable softplus form.
        log_likelihood = jnp.sum(
            y * logits - jax.nn.softplus(logits)
        )
        log_prior = -0.5 * jnp.sum(jnp.square(w))
        return log_likelihood + log_prior

    example_position = jnp.zeros(dim, dtype=jnp.float32)
    return logprob_fn, example_position
