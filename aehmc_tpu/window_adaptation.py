"""Stan-style window adaptation (warmup).

Rewrite of ref window_adaptation.py.  The schedule is computed in Python at
trace time and baked into the compiled program as two constant arrays
(exactly the trick the reference uses at ref window_adaptation.py:127-130);
the warmup loop is one ``lax.scan`` so an entire 1000-step warmup is a single
XLA computation.  Both the fast- and slow-update branches are computed every
step and selected — the XLA-friendly pattern the reference already follows
(ref window_adaptation.py:217-225).

One deliberate change vs the reference: the dual-averaging shrinkage point is
``mu = log(10 * step_size)`` and the log-step-size iterate starts at
``log(step_size)`` (Stan's scheme), where the reference passes the *raw*
step size as ``mu`` and starts the iterate at 0 (ref
window_adaptation.py:140-142, 180-181) — correct only near ``step_size = 1``.
"""

from typing import Callable, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu.config import WindowSchedule
from aehmc_tpu.mass_matrix import covariance_adaptation
from aehmc_tpu.step_size import dual_averaging_adaptation
from aehmc_tpu.types import (
    ChainState,
    Diagnostics,
    DualAveragingState,
    WelfordState,
)


_SCHEDULE = WindowSchedule()  # single source of Stan's 75/25/50 defaults


class WindowAdaptationState(NamedTuple):
    da_state: DualAveragingState
    wc_state: WelfordState
    step_size: jax.Array
    inverse_mass_matrix: jax.Array


def build_schedule(
    num_steps: int,
    initial_buffer_size: int = _SCHEDULE.initial_buffer,
    final_buffer_size: int = _SCHEDULE.final_buffer,
    first_window_size: int = _SCHEDULE.first_window,
) -> List[Tuple[int, bool]]:
    """Return Stan's warmup schedule as ``(stage, is_middle_window_end)`` pairs.

    Stage 0 = fast (step size only), stage 1 = slow (step size + covariance).
    Middle windows double in size; the last absorbs the remainder.  Mirrors
    ref window_adaptation.py:230-327 including the golden cases at
    ref tests/test_adaptation.py:6-28.
    """
    schedule = []
    if num_steps < 20:
        # Too few steps for mass-matrix adaptation.
        schedule += [(0, False)] * num_steps
        return schedule

    if initial_buffer_size + first_window_size + final_buffer_size > num_steps:
        initial_buffer_size = int(0.15 * num_steps)
        final_buffer_size = int(0.1 * num_steps)
        first_window_size = num_steps - initial_buffer_size - final_buffer_size

    schedule += [(0, False)] * initial_buffer_size

    final_buffer_start = num_steps - final_buffer_size
    next_window_size = first_window_size
    next_window_start = initial_buffer_size
    while next_window_start < final_buffer_start:
        current_start, current_size = next_window_start, next_window_size
        if 3 * current_size <= final_buffer_start - current_start:
            next_window_size = 2 * current_size
        else:
            current_size = final_buffer_start - current_start
        next_window_start = current_start + current_size
        schedule += [(1, False)] * (next_window_start - 1 - current_start)
        schedule.append((1, True))

    schedule += [(0, False)] * (num_steps - final_buffer_start)
    return schedule


def window_adaptation(
    num_steps: int,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    *,
    welford_update_fn: Callable = None,
    acceptance_statistic: Callable = None,
    num_dims_fn: Callable = None,
) -> Tuple[Callable, Callable]:
    """Build ``(init, update)`` for the window-adaptation state machine.

    Mirrors ref window_adaptation.py:119-227.  The three keyword hooks let
    pooled (cross-chain) adaptation reuse this exact state machine
    (:func:`aehmc_tpu.parallel.pooled.pooled_window_adaptation`):
    ``welford_update_fn(position_or_batch, wc_state)`` replaces the
    single-sample Welford update, ``acceptance_statistic(info)`` reduces the
    acceptance probabilities, ``num_dims_fn(position)`` extracts the model
    dimension from a possibly chain-batched position.
    """
    mm_init, mm_update, mm_final = covariance_adaptation(is_mass_matrix_full)
    da_init, da_update = dual_averaging_adaptation(target_acceptance_rate)
    if welford_update_fn is None:
        welford_update_fn = mm_update
    if acceptance_statistic is None:
        acceptance_statistic = lambda info: info.acceptance_probability  # noqa: E731
    if num_dims_fn is None:
        num_dims_fn = lambda position: (  # noqa: E731
            0 if position.ndim == 0 else position.shape[0]
        )
    schedule = build_schedule(num_steps)
    schedule_stage = jnp.asarray([s[0] for s in schedule], dtype=jnp.int32)
    schedule_middle_window = jnp.asarray(
        [s[1] for s in schedule], dtype=bool
    )

    def _new_da_state(step_size: jax.Array) -> DualAveragingState:
        log_step_size = jnp.log(step_size)
        state = da_init(jnp.log(10.0) + log_step_size)
        # gradient_avg must match the step-size shape (a PER-CHAIN vector
        # when the caller adapts each chain's eps against its own
        # acceptance — pooled per_chain_step_size);
        # da_init pins it to a scalar, which would change the scan-carry
        # shape on the first vector update.  zeros_like is a no-op for
        # the scalar path.
        return state._replace(
            iterates=log_step_size,
            iterates_avg=log_step_size,
            gradient_avg=jnp.zeros_like(log_step_size),
        )

    def init(
        initial_chain_state: ChainState, step_size=None
    ) -> WindowAdaptationState:
        """``step_size`` (possibly traced) overrides ``initial_step_size`` —
        used to seat the dual-averaging state at a searched value
        (:func:`aehmc_tpu.step_size.find_reasonable_step_size`)."""
        position = initial_chain_state.position
        num_dims = num_dims_fn(position)
        dtype = position.dtype
        inverse_mass_matrix, wc_state = mm_init(num_dims, dtype=dtype)
        step_size = jnp.asarray(
            initial_step_size if step_size is None else step_size, dtype=dtype
        )
        return WindowAdaptationState(
            da_state=_new_da_state(step_size),
            wc_state=wc_state,
            step_size=step_size,
            inverse_mass_matrix=inverse_mass_matrix,
        )

    def _slow_final(
        da_state: DualAveragingState, wc_state: WelfordState
    ) -> WindowAdaptationState:
        """End of a middle window: recompute M^{-1}, reset Welford, re-init
        dual averaging at the current step size (ref
        window_adaptation.py:165-182)."""
        inverse_mass_matrix = mm_final(wc_state)
        num_dims = (
            0
            if inverse_mass_matrix.ndim == 0
            else inverse_mass_matrix.shape[0]
        )
        _, new_wc_state = mm_init(num_dims, dtype=inverse_mass_matrix.dtype)
        step_size = jnp.exp(da_state.iterates)
        return WindowAdaptationState(
            da_state=_new_da_state(step_size),
            wc_state=new_wc_state,
            step_size=step_size,
            inverse_mass_matrix=inverse_mass_matrix,
        )

    def update(
        step: jax.Array,
        state: WindowAdaptationState,
        position: jax.Array,
        info: Diagnostics,
    ) -> WindowAdaptationState:
        """One adaptation step, dispatching on the precomputed schedule."""
        # Dual averaging runs every step; Welford only in slow windows.
        new_da_state = da_update(acceptance_statistic(info), state.da_state)
        step_size = jnp.exp(new_da_state.iterates)

        is_slow = jnp.equal(schedule_stage[step], 1)
        updated_wc = welford_update_fn(position, state.wc_state)
        new_wc_state = jax.tree_util.tree_map(
            lambda s, k: jnp.where(is_slow, s, k), updated_wc, state.wc_state
        )

        updated = WindowAdaptationState(
            da_state=new_da_state,
            wc_state=new_wc_state,
            step_size=step_size,
            inverse_mass_matrix=state.inverse_mass_matrix,
        )

        # End of a middle window?
        window_end = _slow_final(updated.da_state, updated.wc_state)
        is_middle_window_end = schedule_middle_window[step]
        updated = jax.tree_util.tree_map(
            lambda w, u: jnp.where(is_middle_window_end, w, u),
            window_end,
            updated,
        )

        # On the very last step, switch to the averaged iterate
        # (ref window_adaptation.py:184-190).
        is_last_step = jnp.equal(step, num_steps - 1)
        final_step_size = jnp.exp(updated.da_state.iterates_avg)
        return updated._replace(
            step_size=jnp.where(is_last_step, final_step_size, updated.step_size)
        )

    return init, update


def run(
    rng_key: jax.Array,
    kernel: Callable,
    initial_state: ChainState,
    num_steps: int = 1000,
    *,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    search_initial_step_size: bool = True,
) -> Tuple[ChainState, Tuple[jax.Array, jax.Array], Diagnostics]:
    """Run the full warmup as one jitted scan (ref window_adaptation.py:17-116).

    Parameters
    ----------
    kernel
        NUTS-style transition,
        ``kernel(key, state, step_size, inverse_mass_matrix)``.
        For HMC close over ``num_integration_steps``.
    search_initial_step_size
        Start dual averaging from a Stan-style doubling/halving search
        (:func:`aehmc_tpu.step_size.find_reasonable_step_size`) seeded at
        ``initial_step_size``, so badly-scaled posteriors warm up from the
        default init (the reference always starts blind from the user's
        value, ref window_adaptation.py:17-24).

    Returns
    -------
    ``(last_state, (step_size, inverse_mass_matrix), info_history)``.
    """
    init_adapt, update_adapt = window_adaptation(
        num_steps,
        is_mass_matrix_full,
        initial_step_size,
        target_acceptance_rate,
    )
    adaptation_state = init_adapt(initial_state)
    if search_initial_step_size:
        from aehmc_tpu.step_size import find_reasonable_step_size

        rng_key, search_key = jax.random.split(rng_key)
        found = find_reasonable_step_size(
            search_key,
            kernel,
            initial_state,
            adaptation_state.inverse_mass_matrix,
            initial_step_size=adaptation_state.step_size,
        )
        adaptation_state = init_adapt(initial_state, found)

    def one_step(carry, step):
        key, chain_state, adaptation_state = carry
        key, kernel_key = jax.random.split(key)
        new_chain_state, info = kernel(
            kernel_key,
            chain_state,
            adaptation_state.step_size,
            adaptation_state.inverse_mass_matrix,
        )
        new_adaptation_state = update_adapt(
            step, adaptation_state, new_chain_state.position, info
        )
        return (key, new_chain_state, new_adaptation_state), info

    (_, last_state, adaptation_state), info_history = jax.lax.scan(
        one_step,
        (rng_key, initial_state, adaptation_state),
        jnp.arange(num_steps, dtype=jnp.int32),
    )
    return (
        last_state,
        (adaptation_state.step_size, adaptation_state.inverse_mass_matrix),
        info_history,
    )
