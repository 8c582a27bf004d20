"""Metropolis-adjusted Langevin algorithm (MALA).

New capability beyond the reference: a one-gradient-per-step kernel that is
the natural baseline/companion to HMC on accelerators — fully regular computation
(no trajectories at all), ideal for very high chain counts or as a warmup
explorer.  Shares the framework's conventions: pure function over pytrees,
``ChainState`` in/out, ``Diagnostics`` info, counter-based keys.

Proposal: ``q' = q + eps^2/2 * M^{-1} grad(log p)(q) + eps * sqrt(M^{-1}) z``
with the exact asymmetric Metropolis-Hastings correction.
"""

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu.types import ChainState, Diagnostics


def new_state(position: jax.Array, logprob_fn: Callable) -> ChainState:
    potential, grad = jax.value_and_grad(lambda q: -logprob_fn(q))(position)
    return ChainState(position, potential, grad)


def new_kernel(
    logprob_fn: Callable,
    divergence_threshold: float = 1000.0,
) -> Callable:
    """Build a MALA transition kernel.

    Returns ``step(rng_key, state, step_size, inverse_mass_matrix)
    -> (ChainState, Diagnostics)``; ``inverse_mass_matrix`` is a scalar or
    diagonal preconditioner (M^{-1}) — dense matrices are rejected.
    """
    potential_vag = jax.value_and_grad(lambda q: -logprob_fn(q))

    def step(
        rng_key: jax.Array,
        state: ChainState,
        step_size: jax.Array,
        inverse_mass_matrix: jax.Array,
    ) -> Tuple[ChainState, Diagnostics]:
        if jnp.ndim(inverse_mass_matrix) > 1:
            raise ValueError(
                "MALA supports scalar or diagonal preconditioners only; got "
                f"a {jnp.ndim(inverse_mass_matrix)}-d inverse mass matrix"
            )
        noise_key, accept_key = jax.random.split(rng_key)
        eps2 = jnp.square(step_size)
        precond = inverse_mass_matrix
        scale = step_size * jnp.sqrt(precond)

        # drift uses grad(log p) = -grad(U)
        mean_fwd = state.position - 0.5 * eps2 * precond * state.potential_energy_grad
        noise = jax.random.normal(
            noise_key, state.position.shape, state.position.dtype
        )
        proposal = mean_fwd + scale * noise

        new_potential, new_grad = potential_vag(proposal)

        # reverse-move density: q given q'
        mean_bwd = proposal - 0.5 * eps2 * precond * new_grad

        def log_q(x, mean):
            delta = x - mean
            return -0.5 * jnp.sum(jnp.square(delta) / (eps2 * precond))

        log_ratio = (
            (state.potential_energy - new_potential)
            + log_q(state.position, mean_bwd)
            - log_q(proposal, mean_fwd)
        )
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        is_diverging = jnp.abs(log_ratio) > divergence_threshold

        p_accept = jnp.clip(jnp.exp(log_ratio), 0.0, 1.0)
        do_accept = jax.random.bernoulli(accept_key, p_accept)

        new_state_ = ChainState(
            position=jnp.where(do_accept, proposal, state.position),
            potential_energy=jnp.where(
                do_accept, new_potential, state.potential_energy
            ),
            potential_energy_grad=jnp.where(
                do_accept, new_grad, state.potential_energy_grad
            ),
        )
        info = Diagnostics(
            acceptance_probability=p_accept,
            num_doublings=jnp.asarray(0, jnp.int32),
            is_turning=jnp.asarray(False),
            is_diverging=is_diverging,
            energy=new_state_.potential_energy,
            num_integration_steps=jnp.asarray(1, jnp.int32),
        )
        return new_state_, info

    return step
