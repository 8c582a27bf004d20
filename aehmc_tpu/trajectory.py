"""Trajectory construction: static integration, NUTS subtree integration, and
multiplicative (doubling) expansion.

Rewrite of ref trajectory.py (735 LoC of Aesara scans) as three bounded
``lax.while_loop``/``fori_loop`` programs.  The reference's
stack-all-then-take-last scans (ref trajectory.py:86-95, 610-666,
nuts.py:138-151) become running carries — no per-step HBM traffic, and the
whole NUTS transition compiles to a single XLA computation that also batches
cleanly under ``vmap`` (finished chains are masked by the while-loop batching
rule).

Semantics preserved from the reference:

- per-leaf body: integrator step -> proposal + divergence check ->
  progressive-*uniform* resample -> momentum-sum accumulate -> termination
  update + check (ref trajectory.py:195-273),
- the first leaf of a subtree is taken before the loop and the subtree is
  abandoned immediately if that leaf diverges (ref trajectory.py:276-336),
- per-doubling body: random direction, integrate a subtree of ``2**step``
  leaves from the chosen edge, swap edges by direction, merge
  ``sum_log_p_accept`` even when the subtree is rejected, progressive-
  *biased* resample only for cleanly-completed subtrees, full-trajectory
  U-turn check on the new edges (ref trajectory.py:463-608).

One deliberate correction: the reference integrates up to ``max_num_steps``
leaves *after* the initial one (its until-scan at ref trajectory.py:308-332
always runs >= 1 iteration), i.e. up to ``2**step + 1`` leaves per subtree.
Canonical iterative NUTS (NumPyro/TFP/BlackJAX, which the reference cites)
builds balanced subtrees of exactly ``2**step`` leaves; we implement the
canonical bound, which is what the checkpoint U-turn scheme assumes.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from aehmc_tpu.proposals import (
    ProposalState,
    progressive_biased_sampling_from_u,
    progressive_uniform_sampling_from_u,
    proposal_generator,
)
from aehmc_tpu.types import IntegratorState, TerminationState

__all__ = [
    "static_integration",
    "dynamic_integration",
    "multiplicative_expansion",
]


def static_integration(integrator: Callable, num_integration_steps) -> Callable:
    """Build a fixed-length trajectory integrator (ref trajectory.py:31-107).

    Only the endpoint is materialized; ``num_integration_steps`` may be traced.
    """

    def integrate(init_state: IntegratorState, step_size) -> IntegratorState:
        def one_step(_, state):
            return integrator(state, step_size)

        return jax.lax.fori_loop(
            0, num_integration_steps, one_step, init_state
        )

    return integrate


def _default_leaf_uniform(key: jax.Array, leaf_index: jax.Array) -> jax.Array:
    """Per-leaf uniform for progressive sampling (default: fresh PRNG draw).

    ``leaf_index`` is the global leaf index ``2**d - 1 + i`` for leaf ``i``
    of doubling ``d`` — the static stream position an externalized override
    (e.g. an oracle-comparison test) reads instead.
    """
    del leaf_index
    return jax.random.uniform(key)


def dynamic_integration(
    integrator: Callable,
    kinetic_energy: Callable,
    new_termination_state: Callable,
    update_termination_state: Callable,
    is_criterion_met: Callable,
    max_num_doublings: int,
    divergence_threshold: float,
    leaf_uniform_fn: Callable = _default_leaf_uniform,
) -> Callable:
    """Integrate one NUTS subtree in one direction until it is complete,
    diverges, or makes a U-turn (ref trajectory.py:119-376).

    The checkpoint buffers are allocated *fresh per subtree call*: within a
    subtree every slot is written (at an even leaf) before it is read (at a
    later odd leaf), so no content crosses doublings — the reference threads
    one TerminationState through the whole expansion (ref trajectory.py:
    520-535) but only its shape survives.  Keeping the buffers out of the
    doubling-loop carry removes two (chains, K, dim)-sized masked selects
    per doubling under vmap — the dominant cost in profiles (PERF.md).

    Returns
    -------
    ``integrate(rng_key, previous_last_state, direction, max_num_steps,
    step_size, initial_energy)`` returning
    ``(proposal, last_state, momentum_sum, trajectory_length, is_diverging,
    has_terminated)``.
    """
    generate_proposal = proposal_generator(kinetic_energy, divergence_threshold)

    def integrate(
        rng_key: jax.Array,
        previous_last_state: IntegratorState,
        direction: jax.Array,
        max_num_steps: jax.Array,
        step_size: jax.Array,
        initial_energy: jax.Array,
    ):
        termination_state = new_termination_state(
            previous_last_state.position, max_num_doublings
        )
        # First leaf of the subtree, taken outside the loop: it seeds the
        # subtree's proposal and is never checked for a U-turn
        # (ref trajectory.py:276-284).
        state = integrator(previous_last_state, direction * step_size)
        proposal, is_diverging = generate_proposal(initial_energy, state)
        momentum_sum = state.momentum
        termination_state = update_termination_state(
            termination_state, momentum_sum, state.momentum, 0
        )

        init_carry = (
            rng_key,
            jnp.asarray(1, dtype=jnp.int32),
            proposal,
            state,
            momentum_sum,
            termination_state,
            is_diverging,
            jnp.asarray(False),
        )

        def cond_fn(carry):
            _, step, _, _, _, _, diverging, terminated = carry
            return (step < max_num_steps) & ~diverging & ~terminated

        def body_fn(carry):
            key, step, proposal, last_state, momentum_sum, term_state, _, _ = carry
            key, sample_key = jax.random.split(key)

            new_state = integrator(last_state, direction * step_size)
            new_proposal, is_diverging = generate_proposal(
                initial_energy, new_state
            )
            u = leaf_uniform_fn(sample_key, (max_num_steps - 1) + step)
            sampled_proposal = progressive_uniform_sampling_from_u(
                u, proposal, new_proposal
            )

            new_momentum_sum = momentum_sum + new_state.momentum
            # Check against the PRE-update buffers (equivalent: writes happen
            # at even steps, real checks at odd steps) so the checkpoint
            # buffers have no read-after-write hazard inside the loop body.
            has_terminated = is_criterion_met(
                term_state, new_momentum_sum, new_state.momentum, step
            )
            new_term_state = update_termination_state(
                term_state, new_momentum_sum, new_state.momentum, step
            )
            return (
                key,
                step + 1,
                sampled_proposal,
                new_state,
                new_momentum_sum,
                new_term_state,
                is_diverging,
                has_terminated,
            )

        (
            _,
            trajectory_length,
            proposal,
            last_state,
            momentum_sum,
            _,
            is_diverging,
            has_terminated,
        ) = jax.lax.while_loop(cond_fn, body_fn, init_carry)

        return (
            proposal,
            last_state,
            momentum_sum,
            trajectory_length,
            is_diverging,
            has_terminated,
        )

    return integrate


def dynamic_integration_paired(
    integrator: Callable,
    kinetic_energy: Callable,
    new_termination_state: Callable,
    update_termination_state: Callable,
    is_criterion_met: Callable,
    max_num_doublings: int,
    divergence_threshold: float,
    leaf_uniform_fn: Callable = _default_leaf_uniform,
) -> Callable:
    """Semantically-equivalent variant of :func:`dynamic_integration` that
    advances TWO leaves per loop iteration.

    Checkpoint *writes* only happen at even leaf steps and non-vacuous U-turn
    *checks* only at odd steps (ref termination.py:115-124 and the empty
    index range at even steps), so pairing (odd, even) makes both facts
    trace-time structure: one buffer write and one turning check per pair
    instead of per leaf, and half the loop iterations.  Leaf order, proposal
    sampling, and stopping semantics are identical; only the PRNG stream
    differs (two sampling keys drawn per iteration).

    Stopped lanes may execute one extra masked integrator step per subtree
    (the pair's second leaf / the epilogue leaf) — wasted work under SPMD,
    outweighed by the halved bookkeeping.
    """
    generate_proposal = proposal_generator(kinetic_energy, divergence_threshold)

    def integrate(
        rng_key: jax.Array,
        previous_last_state: IntegratorState,
        direction: jax.Array,
        max_num_steps: jax.Array,
        step_size: jax.Array,
        initial_energy: jax.Array,
    ):
        termination_state = new_termination_state(
            previous_last_state.position, max_num_doublings
        )

        def one_leaf(key, proposal, last_state, momentum_sum, step,
                     check: bool, term_state):
            """Integrate leaf ``step``; returns the post-leaf quantities."""
            new_state = integrator(last_state, direction * step_size)
            new_proposal, is_diverging = generate_proposal(
                initial_energy, new_state
            )
            u = leaf_uniform_fn(key, (max_num_steps - 1) + step)
            sampled = progressive_uniform_sampling_from_u(
                u, proposal, new_proposal
            )
            new_momentum_sum = momentum_sum + new_state.momentum
            if check:
                has_terminated = is_criterion_met(
                    term_state, new_momentum_sum, new_state.momentum, step
                )
            else:
                has_terminated = jnp.asarray(False)
            return sampled, new_state, new_momentum_sum, is_diverging, has_terminated

        # Leaf 0 (even): seeds the subtree proposal, writes checkpoint slot 0,
        # never checked (ref trajectory.py:276-284).
        state = integrator(previous_last_state, direction * step_size)
        proposal, is_diverging = generate_proposal(initial_energy, state)
        momentum_sum = state.momentum
        termination_state = update_termination_state(
            termination_state, momentum_sum, state.momentum, 0, parity=0
        )

        carry = (
            rng_key,
            jnp.asarray(1, dtype=jnp.int32),  # length = leaves integrated
            proposal,
            state,
            momentum_sum,
            termination_state,
            is_diverging,
            jnp.asarray(False),
        )

        def cond_fn(c):
            _, length, _, _, _, _, diverging, terminated = c
            # next pair is (length, length+1); run it only if the pair's even
            # leaf still fits strictly below the epilogue leaf max-1
            return (length + 1 < max_num_steps) & ~diverging & ~terminated

        def body_fn(c):
            key, length, proposal, last_state, momentum_sum, ts, _, _ = c
            key, key_a, key_b = jax.random.split(key, 3)
            step_a = length  # odd
            step_b = length + 1  # even

            prop_a, state_a, psum_a, div_a, term_a = one_leaf(
                key_a, proposal, last_state, momentum_sum, step_a, True, ts
            )
            ts_a = update_termination_state(
                ts, psum_a, state_a.momentum, step_a, parity=1
            )
            stop_a = div_a | term_a

            prop_b, state_b, psum_b, div_b, _ = one_leaf(
                key_b, prop_a, state_a, psum_a, step_b, False, ts_a
            )
            ts_b = update_termination_state(
                ts_a, psum_b, state_b.momentum, step_b, parity=0
            )

            pick = lambda a, b: jax.tree_util.tree_map(  # noqa: E731
                lambda x, y: jnp.where(stop_a, x, y), a, b
            )
            return (
                key,
                jnp.where(stop_a, length + 1, length + 2),
                pick(prop_a, prop_b),
                pick(state_a, state_b),
                pick(psum_a, psum_b),
                pick(ts_a, ts_b),
                jnp.where(stop_a, div_a, div_b),
                term_a,
            )

        (
            key,
            length,
            proposal,
            last_state,
            momentum_sum,
            termination_state,
            is_diverging,
            has_terminated,
        ) = jax.lax.while_loop(cond_fn, body_fn, carry)

        # Epilogue: the final odd leaf max_num_steps-1 (exists iff max >= 2),
        # whose check decides whether the completed subtree U-turned.
        key, key_e = jax.random.split(key)
        prop_e, state_e, psum_e, div_e, term_e = one_leaf(
            key_e, proposal, last_state, momentum_sum,
            max_num_steps - 1, True, termination_state,
        )
        do_epilogue = (max_num_steps >= 2) & ~is_diverging & ~has_terminated
        pick_e = lambda e, o: jax.tree_util.tree_map(  # noqa: E731
            lambda x, y: jnp.where(do_epilogue, x, y), e, o
        )
        proposal = pick_e(prop_e, proposal)
        last_state = pick_e(state_e, last_state)
        momentum_sum = pick_e(psum_e, momentum_sum)
        length = jnp.where(do_epilogue, length + 1, length)
        is_diverging = jnp.where(do_epilogue, div_e, is_diverging)
        has_terminated = jnp.where(do_epilogue, term_e, has_terminated)

        return (
            proposal,
            last_state,
            momentum_sum,
            length,
            is_diverging,
            has_terminated,
        )

    return integrate


class ExpansionState(NamedTuple):
    """Carry of the doubling loop; replaces the reference's 24 scan slots.

    Note there is no termination state here: checkpoint buffers live only
    inside the subtree integrator (see :func:`dynamic_integration`)."""

    rng_key: jax.Array
    step: jax.Array
    proposal: ProposalState
    left_state: IntegratorState
    right_state: IntegratorState
    momentum_sum: jax.Array
    acceptance_probability: jax.Array
    num_integration_steps: jax.Array
    is_diverging: jax.Array
    is_turning: jax.Array
    has_subtree_terminated: jax.Array


def _default_direction(key: jax.Array, doubling: jax.Array) -> jax.Array:
    """Go-right bit for a doubling (default: fresh Bernoulli(1/2) draw)."""
    del doubling
    return jax.random.bernoulli(key, 0.5)


def _default_bias_uniform(key: jax.Array, doubling: jax.Array) -> jax.Array:
    """Uniform for the biased across-doublings resample (default: PRNG)."""
    del doubling
    return jax.random.uniform(key)


def multiplicative_expansion(
    trajectory_integrator: Callable,
    uturn_check_fn: Callable,
    max_num_expansions: int,
    direction_fn: Callable = _default_direction,
    bias_uniform_fn: Callable = _default_bias_uniform,
) -> Callable:
    """NUTS doubling loop (ref trajectory.py:396-714).

    At each doubling: draw a direction ~ Bernoulli(1/2), integrate a subtree
    of ``2**step`` leaves from that edge, merge, and stop on divergence,
    U-turn, or internal subtree termination.

    ``direction_fn(key, doubling)`` / ``bias_uniform_fn(key, doubling)``
    default to fresh PRNG draws; overriding them externalizes the
    randomness (oracle differential tests).
    """

    def expand(
        rng_key: jax.Array,
        proposal: ProposalState,
        left_state: IntegratorState,
        right_state: IntegratorState,
        momentum_sum: jax.Array,
        initial_energy: jax.Array,
        step_size: jax.Array,
    ) -> ExpansionState:
        dtype = proposal.energy.dtype
        init = ExpansionState(
            rng_key=rng_key,
            step=jnp.asarray(0, dtype=jnp.int32),
            proposal=proposal,
            left_state=left_state,
            right_state=right_state,
            momentum_sum=momentum_sum,
            acceptance_probability=jnp.zeros((), dtype=dtype),
            num_integration_steps=jnp.asarray(0, dtype=jnp.int32),
            is_diverging=jnp.asarray(False),
            is_turning=jnp.asarray(False),
            has_subtree_terminated=jnp.asarray(False),
        )

        def cond_fn(s: ExpansionState):
            return (
                (s.step < max_num_expansions)
                & ~s.is_diverging
                & ~s.is_turning
                & ~s.has_subtree_terminated
            )

        def body_fn(s: ExpansionState) -> ExpansionState:
            key, direction_key, subtree_key, sample_key = jax.random.split(
                s.rng_key, 4
            )

            do_go_right = direction_fn(direction_key, s.step)
            direction = jnp.where(do_go_right, 1.0, -1.0).astype(dtype)
            start_state = jax.tree_util.tree_map(
                lambda r, l: jnp.where(do_go_right, r, l),
                s.right_state,
                s.left_state,
            )

            (
                new_proposal,
                new_state,
                subtree_momentum_sum,
                subtrajectory_length,
                is_diverging,
                has_subtree_terminated,
            ) = trajectory_integrator(
                subtree_key,
                start_state,
                direction,
                jnp.left_shift(jnp.asarray(1, jnp.int32), s.step),
                step_size,
                initial_energy,
            )

            # The subtree integrator always integrates forward in (its own)
            # time; swap the trajectory edges according to the direction
            # (ref trajectory.py:538-545).
            new_left_state = jax.tree_util.tree_map(
                lambda l, n: jnp.where(do_go_right, l, n), s.left_state, new_state
            )
            new_right_state = jax.tree_util.tree_map(
                lambda n, r: jnp.where(do_go_right, n, r), new_state, s.right_state
            )
            new_momentum_sum = s.momentum_sum + subtree_momentum_sum

            # Pseudo-acceptance probability over the states of the final
            # subtree (ref trajectory.py:548-553).
            acceptance_probability = (
                jnp.exp(new_proposal.sum_log_p_accept)
                / subtrajectory_length.astype(dtype)
            )

            # Rejected subtrees still contribute to the acceptance statistic
            # (ref trajectory.py:560-570).
            updated_proposal = s.proposal._replace(
                sum_log_p_accept=jnp.logaddexp(
                    new_proposal.sum_log_p_accept, s.proposal.sum_log_p_accept
                )
            )
            u_bias = bias_uniform_fn(sample_key, s.step)
            sampled_proposal = where_proposal(
                is_diverging | has_subtree_terminated,
                updated_proposal,
                progressive_biased_sampling_from_u(
                    u_bias, s.proposal, new_proposal
                ),
            )

            is_turning = uturn_check_fn(
                new_left_state.momentum,
                new_right_state.momentum,
                new_momentum_sum,
            )

            return ExpansionState(
                rng_key=key,
                step=s.step + 1,
                proposal=sampled_proposal,
                left_state=new_left_state,
                right_state=new_right_state,
                momentum_sum=new_momentum_sum,
                acceptance_probability=acceptance_probability,
                num_integration_steps=s.num_integration_steps
                + subtrajectory_length,
                is_diverging=is_diverging,
                is_turning=is_turning,
                has_subtree_terminated=has_subtree_terminated,
            )

        return jax.lax.while_loop(cond_fn, body_fn, init)

    return expand


def where_proposal(
    do_pick_left: jax.Array,
    left_proposal: ProposalState,
    right_proposal: ProposalState,
) -> ProposalState:
    """Switch between two proposals on a condition (ref trajectory.py:717-735)."""
    return jax.tree_util.tree_map(
        lambda l, r: jnp.where(do_pick_left, l, r),
        left_proposal,
        right_proposal,
    )
