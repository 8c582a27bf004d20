"""Hierarchical targets that stress the tree-doubling control flow
(BASELINE.md config 4)."""

from typing import Callable, Tuple

import jax.numpy as jnp
import jax.scipy.stats as jss


def neals_funnel(dim: int = 10) -> Tuple[Callable, jnp.ndarray]:
    """Neal's funnel: ``v ~ N(0, 3)``, ``x_i | v ~ N(0, exp(v/2))``.

    Position layout: ``q = [v, x_1, ..., x_{dim-1}]``.
    """

    def logprob_fn(q):
        v = q[0]
        x = q[1:]
        lp_v = jss.norm.logpdf(v, 0.0, 3.0)
        lp_x = jnp.sum(jss.norm.logpdf(x, 0.0, jnp.exp(0.5 * v)))
        return lp_v + lp_x

    example_position = jnp.zeros(dim)
    return logprob_fn, example_position


def eight_schools(non_centered: bool = True) -> Tuple[Callable, jnp.ndarray]:
    """The eight-schools hierarchical model (Rubin 1981).

    Position layout: ``q = [mu, log_tau, theta_1..theta_8]`` where theta are
    the standardized effects in the non-centered parameterization.
    """
    y = jnp.asarray(
        [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
    )
    sigma = jnp.asarray([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

    def logprob_fn(q):
        mu, log_tau = q[0], q[1]
        tau = jnp.exp(log_tau)
        theta_raw = q[2:]
        lp = jss.norm.logpdf(mu, 0.0, 5.0)
        lp = lp + jss.norm.logpdf(log_tau, 0.0, 5.0) + log_tau  # half-N-ish
        if non_centered:
            lp = lp + jnp.sum(jss.norm.logpdf(theta_raw, 0.0, 1.0))
            theta = mu + tau * theta_raw
        else:
            theta = theta_raw
            lp = lp + jnp.sum(jss.norm.logpdf(theta, mu, tau))
        lp = lp + jnp.sum(jss.norm.logpdf(y, theta, sigma))
        return lp

    example_position = jnp.concatenate(
        [jnp.zeros(2), jnp.zeros(8)]
    )
    return logprob_fn, example_position


__all__ = ["neals_funnel", "eight_schools"]
