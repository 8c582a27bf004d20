"""Iterative U-turn termination criterion (NumPyro/TFP checkpoint scheme).

Rewrite of ref termination.py:19-235 with two batching-first changes:

1. The reference finds checkpoint indices with two inner Aesara scans
   (ref termination.py:207-231).  Here they are closed-form bit operations on
   the step integer:

   - ``idx_max = popcount(step >> 1)``,
   - ``num_subtrees = trailing_ones(step) = popcount(step ^ (step + 1)) - 1``,
   - ``idx_min = idx_max - num_subtrees + 1``,

   verified against the reference's golden table
   (ref tests/test_termination.py:51-62).

2. The reference's turning check scans checkpoints from ``max_index`` down to
   ``min_index`` with early exit (ref termination.py:164-185).  Here all
   ``max_num_doublings`` slots are checked *vectorized* with a range mask and
   reduced with ``any`` — checkpoint buffers are tiny ``(<=10, dim)`` arrays,
   so one masked batched dot beats a sequential loop on the VPU and keeps the
   transition kernel free of data-dependent inner loops.

Checkpoint writes happen at even leaf steps only (ref termination.py:115-124);
the write index for step 0 is slot 0 (``popcount(0) = 0``).
"""

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu.types import TerminationState


def _popcount(x: jax.Array) -> jax.Array:
    return jax.lax.population_count(x)


def _find_storage_indices(step: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Closed-form replacement for the reference's two index-search scans.

    Equivalent to ref termination.py:192-235: ``idx_max`` counts the complete
    subtrees strictly left of the current leaf's parent chain
    (popcount of ``step // 2``); ``num_subtrees`` counts the trailing-one
    subtrees that end at this leaf.
    """
    step = jnp.asarray(step, dtype=jnp.int32)
    idx_max = _popcount(step >> 1)
    num_subtrees = _popcount(step ^ (step + 1)) - 1
    idx_min = idx_max - num_subtrees + 1
    return idx_min, idx_max


def iterative_uturn(
    is_turning_fn: Callable,
) -> Tuple[Callable, Callable, Callable]:
    """Build the (new_state, update, is_iterative_turning) triple.

    ``is_turning_fn(p_left, p_right, momentum_sum)`` comes from the metric.
    """

    def new_state(position: jax.Array, max_num_doublings: int) -> TerminationState:
        """Allocate zeroed checkpoint buffers (ref termination.py:43-83)."""
        position = jnp.asarray(position)
        shape = (max_num_doublings,) + position.shape
        idx0 = jnp.asarray(0, dtype=jnp.int32)
        return TerminationState(
            momentum_checkpoints=jnp.zeros(shape, dtype=position.dtype),
            momentum_sum_checkpoints=jnp.zeros(shape, dtype=position.dtype),
            min_index=idx0,
            max_index=idx0,
        )

    def update(
        state: TerminationState,
        momentum_sum: jax.Array,
        momentum: jax.Array,
        step: jax.Array,
        parity: int = None,
    ) -> TerminationState:
        """Write checkpoints at even steps; refresh the active index range.

        The write is a broadcast *select* on a one-hot row mask rather than a
        ``.at[idx].set`` scatter: under ``vmap`` over thousands of chains a
        per-lane dynamic-index scatter lowers to an XLA scatter over the whole
        (chains, K, dim) buffer — far slower on an accelerator than the
        equivalent masked select, which stays a fused elementwise op.

        ``parity`` is a static hint when the caller knows the step's parity
        at trace time (the paired trajectory loop does): ``0`` writes
        unconditionally, ``1`` skips the buffers entirely (odd steps never
        write), ``None`` masks on the runtime parity.
        """
        idx_min, idx_max = _find_storage_indices(step)
        if parity == 1:
            return state._replace(min_index=idx_min, max_index=idx_max)

        num_slots = state.momentum_checkpoints.shape[0]
        slot = jax.lax.broadcasted_iota(
            jnp.int32, (num_slots,) + (1,) * (state.momentum_checkpoints.ndim - 1), 0
        )
        row_mask = jnp.equal(slot, idx_max)
        if parity is None:
            row_mask = row_mask & jnp.equal(step % 2, 0)
        momentum_ckpts = jnp.where(
            row_mask, momentum, state.momentum_checkpoints
        )
        momentum_sum_ckpts = jnp.where(
            row_mask, momentum_sum, state.momentum_sum_checkpoints
        )
        return TerminationState(
            momentum_checkpoints=momentum_ckpts,
            momentum_sum_checkpoints=momentum_sum_ckpts,
            min_index=idx_min,
            max_index=idx_max,
        )

    def is_iterative_turning(
        state: TerminationState,
        momentum_sum: jax.Array,
        momentum: jax.Array,
        step: jax.Array = None,
    ) -> jax.Array:
        """Check all subtrees ending at the current (odd) leaf for a U-turn.

        Vectorized over the checkpoint axis: for every slot ``i`` in
        ``[min_index, max_index]`` reconstruct that subtree's momentum sum as
        ``momentum_sum - sum_ckpt[i] + p_ckpt[i]`` and apply the metric's
        turning criterion; reduce with ``any`` (ref termination.py:133-185).

        When ``step`` is given, the active index range is derived from it
        directly so the check can run on the *pre-update* state: checkpoint
        writes only happen at even steps and real checks only at odd steps,
        so check-then-write is equivalent to write-then-check — and breaking
        the read-after-write dependency lets XLA alias the checkpoint
        buffers in the trajectory while-loop carry instead of copying them
        every leaf (see PERF.md).
        """
        max_num_doublings = state.momentum_checkpoints.shape[0]
        idx = jnp.arange(max_num_doublings, dtype=jnp.int32)
        if step is None:
            idx_min, idx_max = state.min_index, state.max_index
        else:
            idx_min, idx_max = _find_storage_indices(step)
        in_range = (idx >= idx_min) & (idx <= idx_max)

        subtree_momentum_sums = (
            momentum_sum
            - state.momentum_sum_checkpoints
            + state.momentum_checkpoints
        )
        # The metric's is_turning reduces over the last axis, so all K slots
        # evaluate in one fused batched pass (no vmap-of-dots).
        turning = is_turning_fn(
            state.momentum_checkpoints, momentum, subtree_momentum_sums
        )
        return jnp.any(turning & in_range)

    return new_state, update, is_iterative_turning
