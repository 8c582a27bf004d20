"""Euclidean (Gaussian) metric for Hamiltonian dynamics.

Rewrite of ref metrics.py:10-106.  Dispatch on the number of dimensions of
the inverse mass matrix happens at *trace* time (shapes are static under
``jit``), so each case compiles to straight-line XLA:

- scalar: elementwise ops,
- diagonal (1-D): elementwise ops,
- dense (2-D): Cholesky + triangular solve via ``jax.scipy.linalg`` and
  matvecs that become one matrix product when the chain axis is vmapped.

Momentum draws use counter-based ``jax.random`` keys instead of the
reference's RandomStream shared state (ref metrics.py:65-68).
"""

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl


def gaussian_metric(
    inverse_mass_matrix: jax.Array,
) -> Tuple[Callable, Callable, Callable]:
    r"""Hamiltonian dynamics on a Euclidean manifold with Gaussian momentum.

    Parameters
    ----------
    inverse_mass_matrix
        Scalar, 1-D (diagonal), or 2-D (dense) inverse mass matrix
        :math:`M^{-1}`.

    Returns
    -------
    momentum_generator(key)
        Draws momentum :math:`p \sim N(0, M)`.
    kinetic_energy(momentum)
        :math:`\tfrac12 p^T M^{-1} p`.
    is_turning(p_left, p_right, momentum_sum)
        Generalized U-turn criterion (Betancourt + Stan-forum refinement,
        ref metrics.py:75-104): with
        :math:`\rho = \sum p - (p_L + p_R)/2`, the trajectory is turning iff
        :math:`\langle v_L, \rho\rangle \le 0` or
        :math:`\langle v_R, \rho\rangle \le 0`.
    """
    inverse_mass_matrix = jnp.asarray(inverse_mass_matrix)
    ndim = inverse_mass_matrix.ndim

    # `dot` and `matmul` operate on the *last* axis so every metric function
    # (kinetic energy, U-turn check) works on arbitrarily-batched inputs —
    # e.g. the termination criterion evaluates all K checkpoint slots in one
    # fused pass instead of a vmap of per-slot dots (a measurable win at
    # 10k chains; see PERF.md).
    if ndim == 0:
        shape: Tuple[int, ...] = ()
        mass_matrix_sqrt = jnp.sqrt(jnp.reciprocal(inverse_mass_matrix))
        dot = lambda x, y: x * y  # noqa: E731
        matmul = lambda x, y: x * y  # noqa: E731
    elif ndim == 1:
        shape = (inverse_mass_matrix.shape[0],)
        mass_matrix_sqrt = jnp.sqrt(jnp.reciprocal(inverse_mass_matrix))
        dot = lambda x, y: jnp.sum(x * y, axis=-1)  # noqa: E731
        matmul = lambda x, y: x * y  # noqa: E731
    elif ndim == 2:
        # M^{-1} = L L^T; the Cholesky factor of M is L^{-T}
        # (ref metrics.py:52-59).
        shape = (inverse_mass_matrix.shape[0],)
        L = jsl.cholesky(inverse_mass_matrix, lower=True)
        identity = jnp.identity(shape[0], dtype=inverse_mass_matrix.dtype)
        mass_matrix_sqrt = jsl.solve_triangular(
            L, identity, lower=True, trans="T"
        )
        dot = lambda x, y: jnp.sum(x * y, axis=-1)  # noqa: E731
        matmul = lambda m, x: jnp.einsum("ij,...j->...i", m, x)  # noqa: E731
    else:
        raise ValueError(
            "Expected a mass matrix of dimension 0 (scalar), 1 (diagonal) or "
            f"2 (dense), got {ndim}"
        )

    def momentum_generator(rng_key: jax.Array) -> jax.Array:
        norm_samples = jax.random.normal(
            rng_key, shape=shape, dtype=inverse_mass_matrix.dtype
        )
        return matmul(mass_matrix_sqrt, norm_samples)

    def kinetic_energy(momentum: jax.Array) -> jax.Array:
        velocity = matmul(inverse_mass_matrix, momentum)
        return 0.5 * dot(velocity, momentum)

    def is_turning(
        momentum_left: jax.Array,
        momentum_right: jax.Array,
        momentum_sum: jax.Array,
    ) -> jax.Array:
        velocity_left = matmul(inverse_mass_matrix, momentum_left)
        velocity_right = matmul(inverse_mass_matrix, momentum_right)
        rho = momentum_sum - (momentum_right + momentum_left) / 2
        turning_at_left = dot(velocity_left, rho) <= 0
        turning_at_right = dot(velocity_right, rho) <= 0
        return turning_at_left | turning_at_right

    return momentum_generator, kinetic_energy, is_turning
