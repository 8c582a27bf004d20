"""No-U-Turn Sampler (iterative NUTS) kernel.

Rewrite of ref nuts.py: assembles metric + velocity-Verlet + iterative U-turn
criterion + subtree integration + multiplicative expansion into one pure
transition kernel compiled to a single XLA computation.  The reference
extracts the last doubling's slice of stacked diagnostics (ref
nuts.py:138-151); here the doubling loop carries running values so there is
nothing to slice.
"""

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu import metrics
from aehmc_tpu.hmc import new_state  # noqa: F401  (ref nuts.py:14)
from aehmc_tpu.integrators import velocity_verlet
from aehmc_tpu.proposals import ProposalState
from aehmc_tpu.termination import iterative_uturn
from aehmc_tpu.trajectory import (
    dynamic_integration,
    dynamic_integration_paired,
    multiplicative_expansion,
)
from aehmc_tpu.types import ChainState, Diagnostics, IntegratorState


def new_kernel(
    logprob_fn: Callable,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    integrator: Callable = velocity_verlet,
    paired_leaves: bool = True,
) -> Callable:
    """Build an iterative NUTS transition kernel (ref nuts.py:17-155).

    Parameters
    ----------
    logprob_fn
        Log-density of the target, ``position -> scalar``.
    max_num_expansions
        Maximum number of trajectory doublings (max tree depth).
    divergence_threshold
        Energy difference above which a transition is declared divergent.
    integrator
        Symplectic scheme factory (default velocity Verlet; see
        :mod:`aehmc_tpu.integrators`).
    paired_leaves
        Use the two-leaves-per-iteration subtree loop (default): same
        semantics, half the checkpoint bookkeeping per leaf at the cost of
        one extra masked integrator step per subtree.  Faster at every tree
        depth once checkpoint buffers stopped crossing doublings (PERF.md);
        set False for the reference-shaped single-leaf loop.

    Returns
    -------
    ``step(rng_key, state, step_size, inverse_mass_matrix)
    -> (ChainState, Diagnostics)``.
    """

    def potential_fn(x):
        return -logprob_fn(x)

    def step(
        rng_key: jax.Array,
        state: ChainState,
        step_size: jax.Array,
        inverse_mass_matrix: jax.Array,
    ) -> Tuple[ChainState, Diagnostics]:
        momentum_key, expansion_key = jax.random.split(rng_key)

        (
            momentum_generator,
            kinetic_energy_fn,
            uturn_check_fn,
        ) = metrics.gaussian_metric(inverse_mass_matrix)
        symplectic_integrator = integrator(potential_fn, kinetic_energy_fn)
        (
            new_termination_state,
            update_termination_state,
            is_criterion_met,
        ) = iterative_uturn(uturn_check_fn)
        integration = (
            dynamic_integration_paired if paired_leaves else dynamic_integration
        )
        trajectory_integrator = integration(
            symplectic_integrator,
            kinetic_energy_fn,
            new_termination_state,
            update_termination_state,
            is_criterion_met,
            max_num_expansions,
            divergence_threshold,
        )
        expand = multiplicative_expansion(
            trajectory_integrator, uturn_check_fn, max_num_expansions
        )

        initial_state = IntegratorState(
            position=state.position,
            momentum=momentum_generator(momentum_key),
            potential_energy=state.potential_energy,
            potential_energy_grad=state.potential_energy_grad,
        )
        initial_energy = initial_state.potential_energy + kinetic_energy_fn(
            initial_state.momentum
        )
        # weight=0, sum_log_p_accept=-inf (ref nuts.py:120-125).
        initial_proposal = ProposalState(
            state=ChainState(
                position=initial_state.position,
                potential_energy=initial_state.potential_energy,
                potential_energy_grad=initial_state.potential_energy_grad,
            ),
            energy=initial_energy,
            weight=jnp.zeros_like(initial_energy),
            sum_log_p_accept=jnp.full_like(initial_energy, -jnp.inf),
        )

        result = expand(
            expansion_key,
            initial_proposal,
            initial_state,
            initial_state,
            initial_state.momentum,
            initial_energy,
            step_size,
        )

        new_chain_state = result.proposal.state
        info = Diagnostics(
            acceptance_probability=result.acceptance_probability,
            num_doublings=result.step,
            is_turning=result.is_turning,
            is_diverging=result.is_diverging,
            energy=result.proposal.energy,
            num_integration_steps=result.num_integration_steps,
        )
        return new_chain_state, info

    return step


def new_externalized_kernel(
    logprob_fn: Callable,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    integrator: Callable = velocity_verlet,
    paired_leaves: bool = True,
) -> Callable:
    """NUTS transition with ALL randomness passed in — a pure deterministic
    function for differential testing against :mod:`aehmc_tpu.ops.nuts_oracle`.

    Returns ``step(state, momentum, directions, u_bias, u_leaf, step_size,
    inverse_mass_matrix) -> (ChainState, Diagnostics)`` where

    - ``momentum``: the (pre-drawn) initial momentum,
    - ``directions``: (max_num_expansions,) in {-1, +1} — per-doubling
      direction,
    - ``u_bias``: (max_num_expansions,) uniforms — biased across-doublings
      resample,
    - ``u_leaf``: (2**max_num_expansions,) uniforms — leaf ``i`` of doubling
      ``d`` reads the static index ``2**d - 1 + i`` (the oracle's stream
      convention, so kernel and oracle consume identical randomness
      regardless of early stopping).
    """

    def potential_fn(x):
        return -logprob_fn(x)

    def step(
        state: ChainState,
        momentum: jax.Array,
        directions: jax.Array,
        u_bias: jax.Array,
        u_leaf: jax.Array,
        step_size: jax.Array,
        inverse_mass_matrix: jax.Array,
    ) -> Tuple[ChainState, Diagnostics]:
        (
            _,
            kinetic_energy_fn,
            uturn_check_fn,
        ) = metrics.gaussian_metric(inverse_mass_matrix)
        symplectic_integrator = integrator(potential_fn, kinetic_energy_fn)
        (
            new_termination_state,
            update_termination_state,
            is_criterion_met,
        ) = iterative_uturn(uturn_check_fn)
        integration = (
            dynamic_integration_paired if paired_leaves else dynamic_integration
        )
        trajectory_integrator = integration(
            symplectic_integrator,
            kinetic_energy_fn,
            new_termination_state,
            update_termination_state,
            is_criterion_met,
            max_num_expansions,
            divergence_threshold,
            leaf_uniform_fn=lambda key, idx: u_leaf[idx],
        )
        expand = multiplicative_expansion(
            trajectory_integrator,
            uturn_check_fn,
            max_num_expansions,
            direction_fn=lambda key, d: directions[d] > 0,
            bias_uniform_fn=lambda key, d: u_bias[d],
        )

        initial_state = IntegratorState(
            position=state.position,
            momentum=momentum,
            potential_energy=state.potential_energy,
            potential_energy_grad=state.potential_energy_grad,
        )
        initial_energy = initial_state.potential_energy + kinetic_energy_fn(
            initial_state.momentum
        )
        initial_proposal = ProposalState(
            state=ChainState(
                position=initial_state.position,
                potential_energy=initial_state.potential_energy,
                potential_energy_grad=initial_state.potential_energy_grad,
            ),
            energy=initial_energy,
            weight=jnp.zeros_like(initial_energy),
            sum_log_p_accept=jnp.full_like(initial_energy, -jnp.inf),
        )

        result = expand(
            jax.random.PRNGKey(0),  # threaded but never consumed
            initial_proposal,
            initial_state,
            initial_state,
            initial_state.momentum,
            initial_energy,
            step_size,
        )

        info = Diagnostics(
            acceptance_probability=result.acceptance_probability,
            num_doublings=result.step,
            is_turning=result.is_turning,
            is_diverging=result.is_diverging,
            energy=result.proposal.energy,
            num_integration_steps=result.num_integration_steps,
        )
        return result.proposal.state, info

    return step
