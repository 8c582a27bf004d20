"""ChEES-HMC: adaptive-trajectory-length HMC for many parallel chains.

Implements the ChEES criterion of Hoffman, Radul & Sountsov (2021), "An
Adaptive-MCMC Scheme for Setting Trajectory Lengths in Hamiltonian Monte
Carlo" (AISTATS).  This sampler is a *new capability* beyond the reference —
it is the regular alternative to NUTS for chain-parallel execution:

- every chain takes the SAME number of leapfrog steps per iteration (a
  shared Halton-jittered trajectory length), so there is no per-chain
  control flow, no tree bookkeeping, and no vmap straggler effect — each
  iteration is a dense, fully-regular batch of leapfrog steps;
- the trajectory length is adapted by maximizing the Change in the
  Expected Squared jump distance (ChEES) criterion with a cross-chain
  gradient estimate (one ``psum`` over the chain mesh axis per step) and
  Adam on ``log(h)``;
- the step size is adapted by dual averaging toward the HMC-optimal 0.651
  acceptance rate, and the diagonal mass matrix by pooled Welford windows.

All cross-chain reductions are means over the leading chain axis: sharded
over a mesh they lower to cross-device collectives.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu import metrics
from aehmc_tpu.algorithms import (
    pairwise_mean,
    pairwise_sum,
    welford_update_batch,
)
from aehmc_tpu.integrators import velocity_verlet
from aehmc_tpu.mass_matrix import covariance_adaptation
from aehmc_tpu.step_size import dual_averaging_adaptation
from aehmc_tpu.types import ChainState, IntegratorState
from aehmc_tpu.window_adaptation import build_schedule

OPTIMAL_TARGET_ACCEPTANCE = 0.651


class CheesInfo(NamedTuple):
    acceptance_probability: jax.Array  # per chain
    is_diverging: jax.Array  # per chain
    proposed_position: jax.Array  # (chains, dim) — endpoint even if rejected
    proposed_velocity: jax.Array  # (chains, dim)
    num_integration_steps: jax.Array  # scalar, shared across chains
    energy: jax.Array


class CheesSampleInfo(NamedTuple):
    """Per-draw diagnostics stacked by :func:`sample`.

    ``acceptance_probability``, ``is_diverging`` and ``energy`` are
    (draws, chains); ``num_integration_steps`` is (draws,) — the trajectory
    length is shared across chains by construction.
    """

    acceptance_probability: jax.Array
    num_integration_steps: jax.Array
    is_diverging: jax.Array
    energy: jax.Array


class AdamState(NamedTuple):
    m: jax.Array
    v: jax.Array
    step: jax.Array


def halton(index: jax.Array, bits: int = 24) -> jax.Array:
    """Base-2 radical-inverse (van der Corput) sequence in (0, 1).

    A low-discrepancy jitter shared by all chains each iteration (the
    scheme used in the ChEES paper / TFP's implementation).
    """
    index = (jnp.asarray(index, jnp.uint32) + 1) & ((1 << bits) - 1)
    rev = jnp.zeros_like(index)
    for _ in range(bits):
        rev = (rev << 1) | (index & 1)
        index = index >> 1
    return rev.astype(jnp.float32) / jnp.float32(1 << bits)


def new_kernel(
    logprob_fn: Callable,
    divergence_threshold: float = 1000.0,
    integrator: Callable = velocity_verlet,
) -> Callable:
    """Build the batched ChEES-HMC transition.

    Returns ``step(rng_key, states, step_size, num_integration_steps,
    inverse_mass_matrix) -> (ChainState, CheesInfo)`` where ``states`` has a
    leading chain axis and ``num_integration_steps`` is a *shared* (possibly
    traced) integer.
    """

    def potential_fn(x):
        return -logprob_fn(x)

    def step(
        rng_key: jax.Array,
        states: ChainState,
        step_size: jax.Array,
        num_integration_steps: jax.Array,
        inverse_mass_matrix: jax.Array,
    ) -> Tuple[ChainState, CheesInfo]:
        num_chains = states.position.shape[0]
        momentum_key, accept_key = jax.random.split(rng_key)

        momentum_generator, kinetic_energy_fn, _ = metrics.gaussian_metric(
            inverse_mass_matrix
        )
        one_step = integrator(potential_fn, kinetic_energy_fn)

        def propose(key, state: ChainState):
            momentum = momentum_generator(key)
            init = IntegratorState(
                position=state.position,
                momentum=momentum,
                potential_energy=state.potential_energy,
                potential_energy_grad=state.potential_energy_grad,
            )
            final = jax.lax.fori_loop(
                0,
                num_integration_steps,
                lambda _, s: one_step(s, step_size),
                init,
            )
            final = final._replace(momentum=-final.momentum)
            energy = init.potential_energy + kinetic_energy_fn(init.momentum)
            new_energy = final.potential_energy + kinetic_energy_fn(
                final.momentum
            )
            delta = energy - new_energy
            delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
            diverging = jnp.abs(delta) > divergence_threshold
            p_accept = jnp.clip(jnp.exp(delta), 0.0, 1.0)
            return init, final, p_accept, diverging, new_energy, energy

        momentum_keys = jax.random.split(momentum_key, num_chains)
        init, final, p_accept, diverging, new_energy, energy = jax.vmap(
            propose
        )(momentum_keys, states)

        do_accept = jax.random.bernoulli(accept_key, p_accept, (num_chains,))
        pick = lambda n, o: jnp.where(  # noqa: E731
            do_accept.reshape((-1,) + (1,) * (n.ndim - 1)), n, o
        )
        accepted = jax.tree_util.tree_map(pick, final, init)

        new_states = ChainState(
            position=accepted.position,
            potential_energy=accepted.potential_energy,
            potential_energy_grad=accepted.potential_energy_grad,
        )
        # endpoint *velocity* (M^{-1} p, before the flip) drives the ChEES
        # gradient; the flip cancels in the dot product sign convention below.
        velocity = jax.vmap(jax.grad(kinetic_energy_fn))(-final.momentum)

        info = CheesInfo(
            acceptance_probability=p_accept,
            is_diverging=diverging,
            proposed_position=final.position,
            proposed_velocity=velocity,
            num_integration_steps=jnp.asarray(
                num_integration_steps, jnp.int32
            ),
            energy=jnp.where(do_accept, new_energy, energy),
        )
        return new_states, info

    return step


def _chees_gradient(
    positions: jax.Array,
    info: CheesInfo,
    jitter: jax.Array,
) -> jax.Array:
    """Cross-chain estimate of d(ChEES)/d(trajectory length).

    ChEES = 1/4 E[ (||q' - E q'||^2 - ||q - E q||^2)^2 ]; its derivative
    w.r.t. the trajectory length at the proposal endpoint is estimated per
    chain as ``(||q'-q̄'||² - ||q-q̄||²) · (q'-q̄')·v'``, importance-weighted
    by the acceptance probability and scaled by the jitter fraction.
    """
    alpha = info.acceptance_probability
    q = positions
    q_prop = info.proposed_position
    # fixed-tree pairwise reductions over the chain axis: tuned trajectory
    # lengths are bitwise mesh-shape-invariant
    q_mean = pairwise_mean(q, axis=0)
    q_prop_mean = pairwise_mean(q_prop, axis=0)

    delta_prop = q_prop - q_prop_mean
    delta = q - q_mean
    change_sq = jnp.sum(delta_prop**2, axis=-1) - jnp.sum(delta**2, axis=-1)
    dchees_dt = change_sq * jnp.sum(delta_prop * info.proposed_velocity, axis=-1)

    weights = jnp.where(jnp.isfinite(dchees_dt), alpha, 0.0)
    dchees_dt = jnp.where(jnp.isfinite(dchees_dt), dchees_dt, 0.0)
    grad = pairwise_sum(weights * dchees_dt) / jnp.maximum(
        pairwise_sum(weights), 1e-10
    )
    return grad * jitter


def _adam_update(
    grad: jax.Array,
    value: jax.Array,
    state: AdamState,
    learning_rate: float = 0.025,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[jax.Array, AdamState]:
    """One Adam *ascent* step on ``value``."""
    step = state.step + 1
    m = beta1 * state.m + (1.0 - beta1) * grad
    v = beta2 * state.v + (1.0 - beta2) * grad**2
    t = step.astype(value.dtype)
    m_hat = m / (1.0 - beta1**t)
    v_hat = v / (1.0 - beta2**t)
    new_value = value + learning_rate * m_hat / (jnp.sqrt(v_hat) + eps)
    return new_value, AdamState(m=m, v=v, step=step)


class CheesWarmupResult(NamedTuple):
    states: ChainState
    step_size: jax.Array
    trajectory_length: jax.Array
    inverse_mass_matrix: jax.Array


def warmup_hooks(
    logprob_fn: Callable,
    num_chains: int,
    dim: int,
    num_steps: int = 400,
    *,
    initial_step_size: float = 0.1,
    initial_trajectory_length: Optional[float] = None,
    target_acceptance_rate: float = OPTIMAL_TARGET_ACCEPTANCE,
    max_num_integration_steps: int = 1024,
    learning_rate: float = 0.025,
    integrator: Callable = velocity_verlet,
    divergence_threshold: float = 1000.0,
    search_initial_step_size: bool = True,
    dtype=None,
) -> Tuple[Callable, Callable, Callable]:
    """Segmentable ChEES warmup: ``(init, segment, finish)``.

    Same contract as
    :func:`aehmc_tpu.parallel.pooled.pooled_warmup_hooks`: the carry is a
    pure pytree with the PRNG key threaded through it, so scanning the
    step range in slices reproduces the single-scan run bit for bit
    (warmup checkpointing rides on this).  ``finish`` returns a
    :class:`CheesWarmupResult`.
    """
    kernel = new_kernel(
        logprob_fn, divergence_threshold, integrator
    )
    da_init, da_update = dual_averaging_adaptation(target_acceptance_rate)
    mm_init, _, mm_final = covariance_adaptation(False)
    wc_update_batch = welford_update_batch(False)

    schedule = build_schedule(num_steps)
    schedule_stage = jnp.asarray([s[0] for s in schedule], dtype=jnp.int32)
    schedule_middle_window = jnp.asarray([s[1] for s in schedule], dtype=bool)

    if dtype is None:
        dtype = jnp.float32

    def _new_da_state(step_size):
        log_eps = jnp.log(step_size)
        return da_init(jnp.log(10.0) + log_eps)._replace(
            iterates=log_eps, iterates_avg=log_eps
        )

    def init(rng_key, initial_states):
        init_eps = jnp.asarray(initial_step_size, dtype)
        imm0, wc0 = mm_init(dim, dtype=dtype)

        if search_initial_step_size:
            from aehmc_tpu.step_size import find_reasonable_step_size

            rng_key, search_key = jax.random.split(rng_key)
            one_leapfrog = jnp.asarray(1, jnp.int32)
            init_eps = find_reasonable_step_size(
                search_key,
                lambda key, s, eps, imm: kernel(
                    key, s, eps, one_leapfrog, imm
                ),
                initial_states,
                imm0,
                initial_step_size=init_eps,
                target_accept=target_acceptance_rate,
                reduce_fn=pairwise_mean,
            )

        h0 = (
            10.0 * init_eps
            if initial_trajectory_length is None
            else jnp.asarray(initial_trajectory_length, dtype)
        )
        zero = jnp.zeros((), dtype)
        return (
            rng_key,
            initial_states,
            _new_da_state(init_eps),
            AdamState(m=zero, v=zero, step=jnp.asarray(0, jnp.int32)),
            jnp.log(h0),
            wc0,
            imm0,
        )

    def one_step(carry, step):
        key, states, da_state, adam_state, log_h, wc_state, imm = carry
        key, step_key = jax.random.split(key)

        eps = jnp.exp(da_state.iterates)
        h = jnp.exp(log_h)
        jitter = halton(step).astype(dtype)
        num_leapfrog = jnp.clip(
            jnp.ceil(jitter * h / eps).astype(jnp.int32),
            1,
            max_num_integration_steps,
        )

        new_states, info = kernel(step_key, states, eps, num_leapfrog, imm)

        # --- step size: dual averaging on pooled acceptance ---
        mean_accept = pairwise_mean(info.acceptance_probability)
        new_da_state = da_update(mean_accept, da_state)

        # --- trajectory length: Adam ascent on the ChEES gradient ---
        grad = _chees_gradient(states.position, info, jitter.astype(dtype))
        # normalize the gradient scale (per the paper: gradient of log h)
        grad = grad * jnp.exp(log_h)
        new_log_h, new_adam_state = _adam_update(
            grad, log_h, adam_state, learning_rate
        )
        new_log_h = jnp.clip(
            new_log_h,
            jnp.log(eps),
            jnp.log(eps * max_num_integration_steps),
        )

        # --- mass matrix: pooled Welford in slow windows ---
        is_slow = jnp.equal(schedule_stage[step], 1)
        updated_wc = wc_update_batch(new_states.position, wc_state)
        new_wc_state = jax.tree_util.tree_map(
            lambda s, k: jnp.where(is_slow, s, k), updated_wc, wc_state
        )
        window_imm = mm_final(new_wc_state)
        _, fresh_wc = mm_init(dim, dtype=dtype)
        is_window_end = schedule_middle_window[step]
        new_imm = jnp.where(is_window_end, window_imm, imm)
        new_wc_state = jax.tree_util.tree_map(
            lambda f, u: jnp.where(is_window_end, f, u),
            fresh_wc,
            new_wc_state,
        )
        # re-init dual averaging at window ends (like Stan windows)
        window_da = _new_da_state(jnp.exp(new_da_state.iterates))
        new_da_state = jax.tree_util.tree_map(
            lambda w, u: jnp.where(is_window_end, w, u),
            window_da,
            new_da_state,
        )

        return (
            key,
            new_states,
            new_da_state,
            new_adam_state,
            new_log_h,
            new_wc_state,
            new_imm,
        ), info.acceptance_probability

    def segment(wcarry, steps):
        return jax.lax.scan(one_step, wcarry, steps)

    def finish(wcarry):
        _, states, da_state, _, log_h, _, imm = wcarry
        return CheesWarmupResult(
            states=states,
            step_size=jnp.exp(da_state.iterates_avg),
            trajectory_length=jnp.exp(log_h),
            inverse_mass_matrix=imm,
        )

    return init, segment, finish


def warmup(
    rng_key: jax.Array,
    logprob_fn: Callable,
    initial_states: ChainState,
    num_steps: int = 400,
    *,
    initial_step_size: float = 0.1,
    initial_trajectory_length: Optional[float] = None,
    target_acceptance_rate: float = OPTIMAL_TARGET_ACCEPTANCE,
    max_num_integration_steps: int = 1024,
    learning_rate: float = 0.025,
    integrator: Callable = velocity_verlet,
    divergence_threshold: float = 1000.0,
    search_initial_step_size: bool = True,
) -> CheesWarmupResult:
    """Jointly adapt (step size, trajectory length, diag mass matrix).

    One jitted scan: dual averaging on ``log eps`` (pooled mean acceptance),
    Adam ascent on ``log h`` with the ChEES gradient, pooled Welford windows
    for the diagonal inverse mass matrix (Stan schedule).
    ``search_initial_step_size`` seeds both ``eps`` and the default
    trajectory length from a Stan-style doubling/halving search on the
    pooled single-leapfrog acceptance.
    """
    num_chains, dim = initial_states.position.shape
    init, segment, finish = warmup_hooks(
        logprob_fn,
        num_chains,
        dim,
        num_steps,
        initial_step_size=initial_step_size,
        initial_trajectory_length=initial_trajectory_length,
        target_acceptance_rate=target_acceptance_rate,
        max_num_integration_steps=max_num_integration_steps,
        learning_rate=learning_rate,
        integrator=integrator,
        divergence_threshold=divergence_threshold,
        search_initial_step_size=search_initial_step_size,
        dtype=initial_states.position.dtype,
    )
    wcarry = init(rng_key, initial_states)
    wcarry, _ = segment(wcarry, jnp.arange(num_steps, dtype=jnp.int32))
    return finish(wcarry)


def sample(
    rng_key: jax.Array,
    logprob_fn: Callable,
    states: ChainState,
    num_samples: int,
    step_size: jax.Array,
    trajectory_length: jax.Array,
    inverse_mass_matrix: jax.Array,
    *,
    max_num_integration_steps: int = 1024,
    integrator: Callable = velocity_verlet,
    divergence_threshold: float = 1000.0,
    collect_positions: bool = True,
    collect_dtype=None,
    _keys: jax.Array = None,
    _step_offset=0,
):
    """Sample with tuned parameters; trajectory length stays Halton-jittered.

    Returns ``(final_states, positions, infos)`` with positions of shape
    (draws, chains, dim) and ``infos`` a :class:`CheesSampleInfo` — the
    per-chain divergence flags and energies the kernel computes are kept,
    so production ChEES runs report divergences like every other sampler.
    """
    kernel = new_kernel(
        logprob_fn, divergence_threshold, integrator
    )
    dtype = states.position.dtype

    def one_step(carry, inputs):
        states = carry
        step, key = inputs
        jitter = halton(step).astype(dtype)
        num_leapfrog = jnp.clip(
            jnp.ceil(jitter * trajectory_length / step_size).astype(jnp.int32),
            1,
            max_num_integration_steps,
        )
        new_states, info = kernel(
            key, states, step_size, num_leapfrog, inverse_mass_matrix
        )
        if not collect_positions:
            out = None
        elif collect_dtype is not None:
            # narrowed draw storage: halves the history's memory;
            # the chain state stays at full precision
            out = new_states.position.astype(collect_dtype)
        else:
            out = new_states.position
        kept = CheesSampleInfo(
            acceptance_probability=info.acceptance_probability,
            num_integration_steps=info.num_integration_steps,
            is_diverging=info.is_diverging,
            energy=info.energy,
        )
        return new_states, (out, kept)

    # _keys/_step_offset: segmented (checkpointed) drivers pass an explicit
    # slice of the run's key stream plus the global draw offset (the Halton
    # jitter is indexed by the absolute draw number), so segment boundaries
    # don't perturb the draws.
    keys = jax.random.split(rng_key, num_samples) if _keys is None else _keys
    steps = _step_offset + jnp.arange(num_samples, dtype=jnp.int32)
    final_states, (positions, infos) = jax.lax.scan(
        one_step, states, (steps, keys)
    )
    return final_states, positions, infos
