"""Generalized HMC (Horowitz): persistent momentum with partial refresh.

New capability beyond the reference.  One (or a few) leapfrog steps per
transition with the momentum *carried* between transitions:

- partial refresh: ``p <- alpha * p + sqrt(1 - alpha^2) * xi``,
  ``xi ~ N(0, M)``;
- Metropolis-Hastings accept on the energy difference;
- **momentum flip on rejection** (required for detailed balance with
  persistent momentum).

Like ChEES-HMC this is trajectory-regular (every chain does the same number
of leapfrog steps per transition), so it batches perfectly; it is
also the transition kernel underlying MEADS (Hoffman & Sountsov 2022),
planned for a later round (ROADMAP.md).
"""

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu import metrics
from aehmc_tpu.integrators import velocity_verlet
from aehmc_tpu.types import Diagnostics, IntegratorState


def new_state(
    rng_key: jax.Array,
    position: jax.Array,
    logprob_fn: Callable,
    inverse_mass_matrix: jax.Array = None,
) -> IntegratorState:
    """Create a GHMC state: position, an initial momentum draw, U and grad U."""
    if inverse_mass_matrix is None:
        inverse_mass_matrix = (
            jnp.ones_like(position)
            if jnp.ndim(position) > 0
            else jnp.ones((), jnp.asarray(position).dtype)
        )
    momentum_generator, _, _ = metrics.gaussian_metric(inverse_mass_matrix)
    potential_energy, potential_energy_grad = jax.value_and_grad(
        lambda q: -logprob_fn(q)
    )(position)
    return IntegratorState(
        position=position,
        momentum=momentum_generator(rng_key),
        potential_energy=potential_energy,
        potential_energy_grad=potential_energy_grad,
    )


def new_kernel(
    logprob_fn: Callable,
    divergence_threshold: float = 1000.0,
    integrator: Callable = velocity_verlet,
    num_integration_steps: int = 1,
) -> Callable:
    """Build a GHMC transition kernel.

    Returns ``step(rng_key, state, step_size, alpha, inverse_mass_matrix)
    -> (IntegratorState, Diagnostics)`` where ``alpha`` in [0, 1) is the
    momentum-persistence coefficient (``alpha = 0`` refreshes fully, i.e.
    plain 1-step HMC; ``alpha -> 1`` keeps the momentum nearly intact).
    """
    noise_step = new_noise_kernel(
        logprob_fn, divergence_threshold, integrator, num_integration_steps
    )

    def step(
        rng_key: jax.Array,
        state: IntegratorState,
        step_size: jax.Array,
        alpha: jax.Array,
        inverse_mass_matrix: jax.Array,
    ) -> Tuple[IntegratorState, Diagnostics]:
        refresh_key, accept_key = jax.random.split(rng_key)
        momentum_generator, _, _ = metrics.gaussian_metric(
            inverse_mass_matrix
        )
        noise = momentum_generator(refresh_key)
        uniform = jax.random.uniform(accept_key, noise.shape[:-1] or ())
        return noise_step(
            noise, uniform, state, step_size, alpha, inverse_mass_matrix
        )

    return step


def new_noise_kernel(
    logprob_fn: Callable,
    divergence_threshold: float = 1000.0,
    integrator: Callable = velocity_verlet,
    num_integration_steps: int = 1,
) -> Callable:
    """GHMC transition with EXTERNALIZED randomness.

    ``step(noise, uniform, state, step_size, alpha, inverse_mass_matrix)``
    where ``noise ~ N(0, M)`` (the refresh innovation) and ``uniform ~
    U(0,1)`` (the MH coin) are inputs.  Batch drivers (MEADS) draw them
    in bulk — one ``normal`` for the whole chain fleet per draw — instead
    of vmapping per-chain key splits + draws, which costs a measurable
    fraction of the one leapfrog this kernel runs.
    """

    def potential_fn(x):
        return -logprob_fn(x)

    def step(
        noise: jax.Array,
        uniform: jax.Array,
        state: IntegratorState,
        step_size: jax.Array,
        alpha: jax.Array,
        inverse_mass_matrix: jax.Array,
    ) -> Tuple[IntegratorState, Diagnostics]:
        _, kinetic_energy_fn, _ = metrics.gaussian_metric(
            inverse_mass_matrix
        )
        one_step = integrator(potential_fn, kinetic_energy_fn)

        # partial momentum refresh: p ~ N(alpha p, (1 - alpha^2) M)
        momentum = alpha * state.momentum + jnp.sqrt(1.0 - alpha**2) * noise
        init = state._replace(momentum=momentum)

        final = jax.lax.fori_loop(
            0, num_integration_steps, lambda _, s: one_step(s, step_size), init
        )
        final = final._replace(momentum=-final.momentum)

        energy = init.potential_energy + kinetic_energy_fn(init.momentum)
        new_energy = final.potential_energy + kinetic_energy_fn(final.momentum)
        delta = energy - new_energy
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        is_diverging = jnp.abs(delta) > divergence_threshold
        p_accept = jnp.clip(jnp.exp(delta), 0.0, 1.0)
        do_accept = uniform < p_accept

        # Accept the (flipped-momentum) proposal, or keep the current point
        # with the momentum flipped: the flip-flip composition makes accepted
        # moves continue forward while rejections reverse — detailed balance
        # with persistence.  We store the *negated* accepted momentum so the
        # next transition continues in the proposal's direction.
        accepted = jax.tree_util.tree_map(
            lambda n, o: jnp.where(do_accept, n, o),
            final._replace(momentum=-final.momentum),
            init._replace(momentum=-init.momentum),
        )

        info = Diagnostics(
            acceptance_probability=p_accept,
            num_doublings=jnp.asarray(0, jnp.int32),
            is_turning=jnp.asarray(False),
            is_diverging=is_diverging,
            energy=jnp.where(do_accept, new_energy, energy),
            num_integration_steps=jnp.asarray(
                num_integration_steps, jnp.int32
            ),
        )
        return accepted, info

    return step
