"""Generic stochastic-approximation numerics shared by the adaptation layer.

Rewrite of ref algorithms.py: Nesterov/Hoffman-Gelman dual averaging
(ref algorithms.py:17-117) and Welford's online (co)variance estimator
(ref algorithms.py:120-204), plus a Chan-et-al. batched/parallel Welford
merge that the single-chain reference has no use for but which powers
cross-chain pooled adaptation on a device mesh (SURVEY.md §5).
"""

import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu.config import DualAveragingConfig
from aehmc_tpu.types import DualAveragingState, WelfordState

_DA = DualAveragingConfig()  # single source of the Stan defaults


def dual_averaging(
    gamma: float = _DA.gamma, t0: int = _DA.t0, kappa: float = _DA.kappa
) -> Tuple[Callable, Callable]:
    """Nesterov's dual-averaging scheme with Hoffman-Gelman stabilization.

    Default parameters follow Stan (ref algorithms.py:17).

    Returns
    -------
    init(mu)
        Initialize with shrinkage point ``mu``; iterates start at 0
        (ref algorithms.py:56-76).
    update(gradient, state)
        One update: ``eta = 1/(step+t0)``; ``g_avg <- (1-eta) g_avg + eta g``;
        ``x <- mu - (sqrt(step)/gamma) g_avg``;
        ``x_avg <- step^-kappa x + (1 - step^-kappa) x_avg``
        (ref algorithms.py:78-115).
    """

    def init(mu: jax.Array) -> DualAveragingState:
        mu = jnp.asarray(mu)
        zero = jnp.zeros((), dtype=mu.dtype)
        return DualAveragingState(
            step=jnp.asarray(1, dtype=jnp.int32),
            iterates=zero,
            iterates_avg=zero,
            gradient_avg=zero,
            shrinkage_pts=mu,
        )

    def update(gradient: jax.Array, state: DualAveragingState) -> DualAveragingState:
        dtype = state.iterates.dtype
        step = state.step.astype(dtype)
        eta = 1.0 / (step + t0)
        new_gradient_avg = (1.0 - eta) * state.gradient_avg + eta * gradient
        new_x = state.shrinkage_pts - (jnp.sqrt(step) / gamma) * new_gradient_avg
        x_eta = step ** (-kappa)
        new_x_avg = x_eta * state.iterates + (1.0 - x_eta) * state.iterates_avg
        return state._replace(
            step=state.step + 1,
            iterates=new_x.astype(dtype),
            iterates_avg=new_x_avg.astype(dtype),
            gradient_avg=new_gradient_avg.astype(dtype),
        )

    return init, update


def welford_covariance(
    compute_covariance: bool,
) -> Tuple[Callable, Callable, Callable]:
    """Welford's numerically-stable online variance/covariance estimator.

    Mirrors ref algorithms.py:120-204.

    Parameters
    ----------
    compute_covariance
        When True track a dense ``(d, d)`` covariance, otherwise a variance
        vector (or scalar for 0-d positions).
    """

    def init(n_dims: int, dtype=jnp.float32) -> WelfordState:
        sample_size = jnp.asarray(0, dtype=jnp.int32)
        if n_dims == 0:
            zero = jnp.zeros((), dtype=dtype)
            return WelfordState(mean=zero, m2=zero, sample_size=sample_size)
        mean = jnp.zeros((n_dims,), dtype=dtype)
        if compute_covariance:
            m2 = jnp.zeros((n_dims, n_dims), dtype=dtype)
        else:
            m2 = jnp.zeros((n_dims,), dtype=dtype)
        return WelfordState(mean=mean, m2=m2, sample_size=sample_size)

    def update(value: jax.Array, state: WelfordState) -> WelfordState:
        sample_size = state.sample_size + 1
        delta = value - state.mean
        mean = state.mean + delta / sample_size.astype(delta.dtype)
        updated_delta = value - mean
        if compute_covariance and jnp.ndim(mean) > 0:
            m2 = state.m2 + jnp.outer(updated_delta, delta)
        else:
            m2 = state.m2 + updated_delta * delta
        return WelfordState(mean=mean, m2=m2, sample_size=sample_size)

    def final(state: WelfordState) -> jax.Array:
        denominator = jnp.maximum(state.sample_size - 1, 1)
        return state.m2 / denominator.astype(state.m2.dtype)

    return init, update, final


def welford_merge(
    compute_covariance: bool,
) -> Callable[[WelfordState, WelfordState], WelfordState]:
    """Chan-et-al. parallel merge of two Welford states.

    New capability vs the reference (which is single-chain): lets every chain
    — or every mesh shard — run its own Welford accumulator and combine them
    exactly at window ends with one all-reduce across devices.
    """

    def merge(a: WelfordState, b: WelfordState) -> WelfordState:
        n_a = a.sample_size
        n_b = b.sample_size
        n = n_a + n_b
        n_f = jnp.maximum(n, 1).astype(a.mean.dtype)
        delta = b.mean - a.mean
        w_b = n_b.astype(a.mean.dtype) / n_f
        mean = a.mean + delta * w_b
        cross = n_a.astype(a.mean.dtype) * w_b
        if compute_covariance and jnp.ndim(a.mean) > 0:
            m2 = a.m2 + b.m2 + cross * jnp.outer(delta, delta)
        else:
            m2 = a.m2 + b.m2 + cross * delta * delta
        return WelfordState(mean=mean, m2=m2, sample_size=n)

    return merge


def pairwise_sum(x: jax.Array, axis: int = 0) -> jax.Array:
    """Sum along ``axis`` with a FIXED binary-tree order.

    ``jnp.sum`` over a mesh-sharded axis reduces per-shard then combines, so
    its floating-point rounding depends on the mesh shape.  Here each tree
    level is an explicit elementwise add of array halves (zero-padded to a
    power of two — exact in IEEE), so the summation order is a function of
    the *logical* axis length only: pooled statistics become
    bitwise-reproducible across mesh shapes (BASELINE.md determinism north
    star; see tests/test_parallel.py).
    """
    x = jnp.moveaxis(x, axis, 0)
    n = x.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        pad = jnp.zeros((size - n,) + x.shape[1:], x.dtype)
        x = jnp.concatenate([x, pad], axis=0)
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def pairwise_mean(x: jax.Array, axis: int = 0) -> jax.Array:
    """Mean along ``axis`` via :func:`pairwise_sum` (mesh-shape-invariant)."""
    return pairwise_sum(x, axis) / jnp.asarray(x.shape[axis], x.dtype)


def _pairwise_outer_sum(centered: jax.Array, max_chunks: int = 128) -> jax.Array:
    """``centered.T @ centered`` with a mesh-shape-invariant reduction order.

    The chain axis is cut into at most ``max_chunks`` equal contiguous chunks
    (a function of the logical chain count only); each chunk's Gram matrix is
    a fixed-shape matmul, and the chunk results combine in a fixed pairwise
    tree.  Chunks stay shard-local whenever the per-device chain count is a
    multiple of the chunk size (true for power-of-two meshes and chain
    counts), so no partial-matmul collectives reorder the arithmetic.
    """
    n, dim = centered.shape
    num_chunks = math.gcd(n, max_chunks)
    blocks = centered.reshape(num_chunks, n // num_chunks, dim)
    partial = jnp.einsum("bci,bcj->bij", blocks, blocks)
    return pairwise_sum(partial, axis=0)


def welford_update_batch(
    compute_covariance: bool,
) -> Callable[[jax.Array, WelfordState], WelfordState]:
    """Fold a whole batch of values (e.g. one position per chain) into a
    Welford state in one shot.

    Computes the batch's own moments with dense reductions (a matrix product
    for the covariance case) and merges via :func:`welford_merge` — the
    batched alternative to looping the scalar update over chains.  All
    cross-chain reductions use fixed-tree pairwise order
    (:func:`pairwise_sum`) so the tuned mass matrix is bitwise identical
    across mesh shapes.
    """
    merge = welford_merge(compute_covariance)

    def update_batch(values: jax.Array, state: WelfordState) -> WelfordState:
        values = jnp.atleast_1d(values)
        batch = values.shape[0]
        batch_mean = pairwise_mean(values, axis=0)
        centered = values - batch_mean
        if compute_covariance and jnp.ndim(state.mean) > 0:
            batch_m2 = _pairwise_outer_sum(centered)
        else:
            batch_m2 = pairwise_sum(centered * centered, axis=0)
        batch_state = WelfordState(
            mean=batch_mean.astype(state.mean.dtype),
            m2=batch_m2.astype(state.m2.dtype),
            sample_size=jnp.asarray(batch, dtype=state.sample_size.dtype),
        )
        return merge(state, batch_state)

    return update_batch
