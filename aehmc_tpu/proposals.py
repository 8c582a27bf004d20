"""Proposal bookkeeping and progressive sampling for NUTS.

Rewrite of ref proposals.py.  Semantics preserved exactly:

- a proposal's ``weight`` is the energy difference ``H0 - H1`` with NaN
  coerced to ``-inf`` so pathological states reject instead of crashing
  (ref proposals.py:43-44),
- a transition is divergent iff ``|delta_energy| > divergence_threshold``
  (ref proposals.py:45),
- *uniform* progressive sampling is used within a subtree
  (ref proposals.py:72-102), *biased* sampling across doublings
  (ref proposals.py:105-134),
- merging proposals combines weights and ``sum_log_p_accept`` with
  ``logaddexp`` and switches all state fields on the accept bit
  (ref proposals.py:137-174) — here a single ``tree_map`` select.
"""

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu.types import ChainState, IntegratorState, ProposalState


def proposal_generator(
    kinetic_energy: Callable, divergence_threshold: float
) -> Callable:
    """Build the function that turns an integrator state into a proposal."""

    def update(
        initial_energy: jax.Array, state: IntegratorState
    ) -> Tuple[ProposalState, jax.Array]:
        new_energy = state.potential_energy + kinetic_energy(state.momentum)
        delta_energy = initial_energy - new_energy
        delta_energy = jnp.where(jnp.isnan(delta_energy), -jnp.inf, delta_energy)
        is_transition_divergent = jnp.abs(delta_energy) > divergence_threshold

        weight = delta_energy
        # log P(accept) = min(delta_energy, 0)  (ref proposals.py:47-52)
        log_p_accept = jnp.minimum(delta_energy, 0.0)

        return (
            ProposalState(
                state=ChainState(
                    position=state.position,
                    potential_energy=state.potential_energy,
                    potential_energy_grad=state.potential_energy_grad,
                ),
                energy=new_energy,
                weight=weight,
                sum_log_p_accept=log_p_accept,
            ),
            is_transition_divergent,
        )

    return update


def progressive_uniform_sampling_from_u(
    u: jax.Array, proposal: ProposalState, new_proposal: ProposalState
) -> ProposalState:
    """:func:`progressive_uniform_sampling` with the uniform draw passed in
    (externalized randomness for differential testing)."""
    p_accept = jax.scipy.special.expit(new_proposal.weight - proposal.weight)
    p_accept = jnp.where(jnp.isnan(p_accept), 0.0, p_accept)
    do_accept = u < p_accept
    return maybe_update_proposal(do_accept, proposal, new_proposal)


def progressive_uniform_sampling(
    rng_key: jax.Array, proposal: ProposalState, new_proposal: ProposalState
) -> ProposalState:
    """Accept the new proposal w.p. ``sigmoid(w_new - w_old)`` (NaN -> 0).

    Used *inside* a subtree (ref proposals.py:72-102).
    """
    u = jax.random.uniform(rng_key, dtype=proposal.weight.dtype)
    return progressive_uniform_sampling_from_u(u, proposal, new_proposal)


def progressive_biased_sampling_from_u(
    u: jax.Array, proposal: ProposalState, new_proposal: ProposalState
) -> ProposalState:
    """:func:`progressive_biased_sampling` with the uniform draw passed in."""
    p_accept = jnp.clip(jnp.exp(new_proposal.weight - proposal.weight), 0.0, 1.0)
    do_accept = u < p_accept
    return maybe_update_proposal(do_accept, proposal, new_proposal)


def progressive_biased_sampling(
    rng_key: jax.Array, proposal: ProposalState, new_proposal: ProposalState
) -> ProposalState:
    """Accept the new proposal w.p. ``min(1, exp(w_new - w_old))``.

    Biases the transition away from the trajectory's initial state; used
    *across* doublings (ref proposals.py:105-134).
    """
    u = jax.random.uniform(rng_key, dtype=proposal.weight.dtype)
    return progressive_biased_sampling_from_u(u, proposal, new_proposal)


def maybe_update_proposal(
    do_accept: jax.Array, proposal: ProposalState, new_proposal: ProposalState
) -> ProposalState:
    """Select between proposals on ``do_accept``, merging the weights."""
    updated_weight = jnp.logaddexp(proposal.weight, new_proposal.weight)
    updated_sum_log_p_accept = jnp.logaddexp(
        proposal.sum_log_p_accept, new_proposal.sum_log_p_accept
    )
    updated_state = jax.tree_util.tree_map(
        lambda new, old: jnp.where(do_accept, new, old),
        new_proposal.state,
        proposal.state,
    )
    updated_energy = jnp.where(do_accept, new_proposal.energy, proposal.energy)
    return ProposalState(
        state=updated_state,
        energy=updated_energy,
        weight=updated_weight,
        sum_log_p_accept=updated_sum_log_p_accept,
    )
