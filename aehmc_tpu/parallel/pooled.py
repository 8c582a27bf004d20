"""Cross-chain pooled adaptation and mesh-sharded sampling.

New capability vs the single-chain reference (SURVEY.md §2/§5): all chains
share one step size and one inverse mass matrix, adapted from *pooled*
statistics — the mean acceptance probability across chains drives dual
averaging, and every chain's positions fold into one Welford estimate via the
Chan batched merge (:func:`aehmc_tpu.algorithms.welford_update_batch`).
Pooling uses C times more information per adaptation step, so warmup needs
far fewer steps than the reference's 1000 — a genuine algorithmic win from
multi-chain hardware, not just a port.

All reductions are ``jnp.mean``/matmuls over the chain axis: when that axis
is sharded over a mesh, XLA lowers them to an all-reduce across devices.
"""

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu import hmc
from aehmc_tpu.algorithms import pairwise_mean, welford_update_batch
from aehmc_tpu.parallel.mesh import chain_sharding, make_mesh, replicated
from aehmc_tpu.sampling import SampleResult
from aehmc_tpu.types import ChainState, Diagnostics
from aehmc_tpu.window_adaptation import window_adaptation


def pooled_window_adaptation(
    num_steps: int,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    *,
    per_chain_step_size: bool = False,
    num_chains: int = None,
) -> Tuple[Callable, Callable]:
    """(init, update) for warmup driven by pooled cross-chain statistics.

    The exact single-chain Stan-window state machine
    (:func:`aehmc_tpu.window_adaptation.window_adaptation`) with its three
    pooling hooks: mean acceptance across chains drives dual averaging, and
    each step folds the whole chain batch into the Welford state with the
    Chan parallel merge.

    ``per_chain_step_size`` replaces the pooled dual-averaging state with
    one state per chain, each fed its own chain's acceptance (all DA ops
    are elementwise on (chains,) arrays); the mass matrix stays pooled.
    That is the reference's single-chain adaptation semantics vectorized
    across the fleet, and it is trivially mesh-shape-invariant (no
    cross-chain reduction feeds the step size).  Requires ``num_chains``.
    """
    wc_update_batch = welford_update_batch(is_mass_matrix_full)
    if per_chain_step_size:
        if num_chains is None:
            raise ValueError("per_chain_step_size requires num_chains")
        initial_step_size = jnp.full(
            (num_chains,), initial_step_size, jnp.float32
        )
        acceptance_statistic = (
            lambda info: info.acceptance_probability  # noqa: E731
        )
    else:
        # fixed-tree pairwise mean: tuned eps is bitwise mesh-shape-invariant
        acceptance_statistic = lambda info: pairwise_mean(  # noqa: E731
            info.acceptance_probability
        )
    return window_adaptation(
        num_steps,
        is_mass_matrix_full,
        initial_step_size,
        target_acceptance_rate,
        welford_update_fn=wc_update_batch,
        acceptance_statistic=acceptance_statistic,
        num_dims_fn=lambda positions: (
            0 if positions.ndim == 1 else positions.shape[1]
        ),
    )


def pooled_warmup_hooks(
    kernel: Callable,
    num_chains: int,
    num_steps: int = 400,
    *,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    progress_every: int = 0,
    search_initial_step_size: bool = True,
    per_chain_step_size: bool = False,
) -> Tuple[Callable, Callable, Callable]:
    """Segmentable pooled warmup: ``(init, segment, finish)``.

    ``init(key, states) -> wcarry`` builds the adaptation state (and runs
    the initial step-size search); ``segment(wcarry, steps) -> (wcarry,
    infos)`` scans the warmup body over a contiguous slice of absolute
    step indices; ``finish(wcarry) -> (states, (eps, imm))``.  The carry
    is a pure pytree (chain states, WindowAdaptationState, PRNG key), and
    the per-step key stream is threaded THROUGH the carry, so segmenting
    [0, N) into arbitrary slices reproduces the single-scan run bit for
    bit — the property warmup checkpointing (``_checkpointed_run``) rides
    on.
    """
    init_adapt, update_adapt = pooled_window_adaptation(
        num_steps,
        is_mass_matrix_full,
        initial_step_size,
        target_acceptance_rate,
        per_chain_step_size=per_chain_step_size,
        num_chains=num_chains,
    )

    def init(rng_key, initial_states):
        adaptation_state = init_adapt(initial_states)
        if search_initial_step_size:
            from aehmc_tpu.step_size import find_reasonable_step_size

            def batched_kernel(key, states, eps, imm):
                keys = jax.random.split(key, num_chains)
                return jax.vmap(lambda k, s: kernel(k, s, eps, imm))(
                    keys, states
                )

            rng_key, search_key = jax.random.split(rng_key)
            search_eps = adaptation_state.step_size
            if per_chain_step_size:
                # the doubling/halving search probes ONE pooled scalar
                # (its while-loop predicate needs a scalar acceptance);
                # every chain's DA state is then seeded at the found value
                search_eps = search_eps[0]
            found = find_reasonable_step_size(
                search_key,
                batched_kernel,
                initial_states,
                adaptation_state.inverse_mass_matrix,
                initial_step_size=search_eps,
                reduce_fn=pairwise_mean,
            )
            if per_chain_step_size:
                found = jnp.full((num_chains,), found, jnp.float32)
            adaptation_state = init_adapt(initial_states, found)
        return (rng_key, initial_states, adaptation_state)

    def one_step(carry, step):
        key, states, adaptation_state = carry
        key, subkey = jax.random.split(key)
        kernel_keys = jax.random.split(subkey, num_chains)
        if per_chain_step_size:
            new_states, infos = jax.vmap(
                lambda k, s, e: kernel(
                    k, s, e, adaptation_state.inverse_mass_matrix
                )
            )(kernel_keys, states, adaptation_state.step_size)
        else:
            new_states, infos = jax.vmap(
                lambda k, s: kernel(
                    k, s, adaptation_state.step_size,
                    adaptation_state.inverse_mass_matrix,
                )
            )(kernel_keys, states)
        new_adaptation_state = update_adapt(
            step, adaptation_state, new_states.position, infos
        )
        if progress_every:
            from aehmc_tpu.observability import progress_callback

            progress_callback(step, infos, every=progress_every)
        return (key, new_states, new_adaptation_state), infos

    def segment(wcarry, steps):
        return jax.lax.scan(one_step, wcarry, steps)

    def finish(wcarry):
        _, states, adaptation_state = wcarry
        return states, (
            adaptation_state.step_size,
            adaptation_state.inverse_mass_matrix,
        )

    return init, segment, finish


def pooled_warmup(
    rng_key: jax.Array,
    kernel: Callable,
    initial_states: ChainState,
    num_steps: int = 400,
    *,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    progress_every: int = 0,
    search_initial_step_size: bool = True,
    per_chain_step_size: bool = False,
) -> Tuple[ChainState, Tuple[jax.Array, jax.Array], Diagnostics]:
    """Warm up a batch of chains with shared, pooled-adapted parameters.

    ``kernel(key, state, step_size, inverse_mass_matrix)`` is single-chain;
    ``initial_states`` is a ChainState with a leading chain axis.  Set
    ``progress_every=N`` to stream a progress line (step, pooled acceptance,
    divergent-chain count) every N warmup steps from inside the jitted scan.
    ``search_initial_step_size`` seeds dual averaging from a Stan-style
    doubling/halving search on the *pooled* mean acceptance across chains.
    """
    init, segment, finish = pooled_warmup_hooks(
        kernel,
        initial_states.position.shape[0],
        num_steps,
        is_mass_matrix_full=is_mass_matrix_full,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        progress_every=progress_every,
        search_initial_step_size=search_initial_step_size,
        per_chain_step_size=per_chain_step_size,
    )
    wcarry = init(rng_key, initial_states)
    wcarry, info_history = segment(
        wcarry, jnp.arange(num_steps, dtype=jnp.int32)
    )
    states, (eps, imm) = finish(wcarry)
    return states, (eps, imm), info_history


def sample_sharded(
    rng_key: jax.Array,
    logprob_fn: Callable,
    initial_positions: jax.Array,
    num_samples: int = 1000,
    num_warmup: int = 400,
    *,
    algorithm: str = "nuts",
    num_integration_steps: int = 32,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    search_initial_step_size: bool = True,
    per_chain_step_size: bool = False,
    mesh=None,
    collect_positions: bool = True,
    meads_recompute_every: int = 1,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    _crash_after_segments: Optional[int] = None,
    _crash_after_warmup_segments: Optional[int] = None,
) -> SampleResult:
    """Pooled warmup + sampling for a chain batch sharded over a mesh.

    ``initial_positions``: (chains, dim) — the chain axis is sharded over the
    mesh's ``chains`` axis; per-chain transitions need no communication, and
    the pooled-adaptation reductions become collectives across devices.

    Beyond "nuts"/"hmc"/"mala"/"ghmc", ``algorithm`` may be:

    - ``"chees"``: ChEES-HMC warmup + sampling (shared jittered trajectory
      lengths; see :mod:`aehmc_tpu.chees`);
    - ``"meads"``: tuning-free adaptive GHMC with cross-fold hyperparameter
      estimation (see :mod:`aehmc_tpu.meads`); ``num_warmup`` is burn-in
      only — adaptation is part of the kernel and continues while sampling.
      ``meads_recompute_every=k`` amortizes the eigenvalue estimation over
      k-draw segments.

    ``per_chain_step_size=True`` (nuts/hmc/mala/ghmc) adapts one dual
    averaging state per chain — each chain's eps tunes against its own
    acceptance, the reference's single-chain semantics vectorized — while
    the mass matrix stays pooled; the tuned ``step_size`` comes back as a
    ``(chains,)`` vector.

    **Checkpoint / resume** (new capability vs the reference, SURVEY.md §5):
    pass ``checkpoint_every=N, checkpoint_path="run.npz"`` to snapshot the
    full sampling state (chain states, tuned parameters, PRNG key, collected
    draws) every N draws.  With ``resume=True`` a restarted call with the
    SAME arguments continues from the last snapshot and returns a result
    bitwise identical to the uninterrupted run (same mesh): sampling runs in
    fixed segments whose per-step keys are derived once from the post-warmup
    key, so segment boundaries don't perturb the draw stream.  WARMUP is
    checkpointed too (to ``<path>_warmup.npz``): the warmup scan runs in
    ``checkpoint_every``-step segments whose carry threads the PRNG key, so
    a run killed mid-warmup resumes from the last warmup snapshot and still
    reproduces the uninterrupted (checkpointed) run bit for bit.
    ``_crash_after_segments`` / ``_crash_after_warmup_segments`` are test
    hooks that abort after N segments of the respective phase.
    """
    if checkpoint_every and checkpoint_path is None:
        raise ValueError("checkpoint_every requires checkpoint_path")
    if per_chain_step_size and algorithm in ("meads", "chees"):
        raise ValueError(
            f"per_chain_step_size is not supported with "
            f"algorithm={algorithm!r} (MEADS/ChEES manage their own "
            f"step-size adaptation)"
        )
    if algorithm == "meads":
        from aehmc_tpu import meads

        if mesh is None and len(jax.devices()) > 1:
            mesh = make_mesh()
        if mesh is not None:
            initial_positions = jax.device_put(
                initial_positions, chain_sharding(mesh)
            )

        if not checkpoint_every:

            def meads_program(key, positions):
                final_states, positions_out, infos, hyper = meads.sample(
                    key,
                    logprob_fn,
                    positions,
                    num_samples,
                    num_warmup,
                    divergence_threshold=divergence_threshold,
                    collect_positions=collect_positions,
                    recompute_every=meads_recompute_every,
                )
                return SampleResult(
                    final_state=final_states,
                    positions=positions_out,
                    diagnostics=infos,
                    step_size=jnp.mean(hyper.step_size),
                    inverse_mass_matrix=jnp.mean(
                        hyper.inverse_mass_matrix, axis=0
                    ),
                )

            return jax.jit(meads_program)(rng_key, initial_positions)

        # Checkpointed MEADS: the segment carry is the MeadsCarry (chain
        # states + hyperparameters in force + iteration counter).
        meads_kernel = meads.new_kernel(
            logprob_fn,
            divergence_threshold=divergence_threshold,
            recompute_every=meads_recompute_every,
        )

        def meads_burn_step(carry, k):
            new_carry, _ = meads_kernel(k, carry)
            return new_carry, None

        def meads_warmup_program(key, positions):
            init_key, warm_key, sample_key = jax.random.split(key, 3)
            carry = meads.init_carry(init_key, positions, logprob_fn)

            if num_warmup > 0:
                carry, _ = jax.lax.scan(
                    meads_burn_step, carry,
                    jax.random.split(warm_key, num_warmup),
                )
            return carry, (), sample_key

        # Segmentable warmup: the carry holds the pre-split burn-in key
        # array, so slicing the step range replays the exact key stream
        # of the single-scan path.
        def meads_wh_init(key, positions):
            init_key, warm_key, sample_key = jax.random.split(key, 3)
            carry = meads.init_carry(init_key, positions, logprob_fn)
            keys = jax.random.split(warm_key, max(num_warmup, 1))
            return (carry, keys), sample_key

        def meads_wh_segment(wcarry, steps):
            carry, keys = wcarry
            carry, _ = jax.lax.scan(meads_burn_step, carry, keys[steps])
            return (carry, keys)

        def meads_wh_finish(wcarry):
            carry, _ = wcarry
            return carry, ()

        def meads_wh_place(wcarry):
            if mesh is None:
                return wcarry
            carry, keys = wcarry
            rep = replicated(mesh)
            return (
                meads.MeadsCarry(
                    states=jax.device_put(
                        carry.states, chain_sharding(mesh)
                    ),
                    hyper=jax.device_put(carry.hyper, rep),
                    step=jax.device_put(carry.step, rep),
                ),
                jax.device_put(keys, rep),
            )

        def meads_segment(carry, keys, seg_start, extras):
            def draw_step(carry, k):
                new_carry, infos = meads_kernel(k, carry)
                out = (
                    new_carry.states.position
                    if collect_positions
                    else None
                )
                return new_carry, (out, infos)

            return jax.lax.scan(draw_step, carry, keys)

        def meads_build_result(carry, extras, outs):
            positions_out, infos = outs
            return SampleResult(
                final_state=carry.states,
                positions=positions_out if collect_positions else None,
                diagnostics=infos,
                step_size=jnp.mean(jnp.asarray(carry.hyper.step_size)),
                inverse_mass_matrix=jnp.mean(
                    jnp.asarray(carry.hyper.inverse_mass_matrix), axis=0
                ),
            )

        def meads_place_carry(carry):
            rep = replicated(mesh)
            return meads.MeadsCarry(
                states=jax.device_put(carry.states, chain_sharding(mesh)),
                hyper=jax.device_put(carry.hyper, rep),
                step=jax.device_put(carry.step, rep),
            )

        return _checkpointed_run(
            rng_key, initial_positions, meads_warmup_program,
            meads_segment, meads_build_result, num_samples,
            checkpoint_every, checkpoint_path, resume, collect_positions,
            mesh, _crash_after_segments,
            warmup_hooks=(
                meads_wh_init, meads_wh_segment, meads_wh_finish,
                meads_wh_place,
            ),
            num_warmup=num_warmup,
            _crash_after_warmup_segments=_crash_after_warmup_segments,
            place_carry=meads_place_carry,
        )
    if algorithm == "chees":
        from aehmc_tpu import chees

        if mesh is None and len(jax.devices()) > 1:
            mesh = make_mesh()
        if mesh is not None:
            initial_positions = jax.device_put(
                initial_positions, chain_sharding(mesh)
            )

        def _chees_diagnostics(chees_info):
            accept = chees_info.acceptance_probability  # (draws, chains)
            return Diagnostics(
                acceptance_probability=accept,
                # ChEES has no tree: doublings/turning are structurally zero,
                # broadcast per-chain so every field is (draws, chains).
                num_doublings=jnp.zeros(accept.shape, jnp.int32),
                is_turning=jnp.zeros(accept.shape, bool),
                is_diverging=chees_info.is_diverging,
                energy=chees_info.energy,
                num_integration_steps=jnp.broadcast_to(
                    jnp.asarray(chees_info.num_integration_steps)[:, None],
                    accept.shape,
                ),
            )

        def chees_warmup_program(key, positions):
            states = jax.vmap(lambda q: hmc.new_state(q, logprob_fn))(
                positions
            )
            warmup_key, sample_key = jax.random.split(key)
            result = chees.warmup(
                warmup_key,
                logprob_fn,
                states,
                num_steps=max(num_warmup, 1),
                initial_step_size=initial_step_size,
                divergence_threshold=divergence_threshold,
                search_initial_step_size=search_initial_step_size,
            )
            extras = (
                result.step_size,
                result.trajectory_length,
                result.inverse_mass_matrix,
            )
            return result.states, extras, sample_key

        def chees_segment(states, keys, seg_start, extras):
            eps, h, imm = extras
            final_states, positions_out, chees_info = chees.sample(
                None,
                logprob_fn,
                states,
                keys.shape[0],
                eps,
                h,
                imm,
                divergence_threshold=divergence_threshold,
                collect_positions=collect_positions,
                _keys=keys,
                _step_offset=seg_start,
            )
            return final_states, (positions_out, chees_info)

        def chees_build_result(states, extras, outs):
            eps, h, imm = extras
            positions_out, chees_info = outs
            return SampleResult(
                final_state=states,
                positions=positions_out if collect_positions else None,
                diagnostics=_chees_diagnostics(chees_info),
                step_size=eps,
                inverse_mass_matrix=imm,
            )

        if not checkpoint_every:

            def chees_program(key, positions):
                states, extras, sample_key = chees_warmup_program(
                    key, positions
                )
                keys = jax.random.split(sample_key, num_samples)
                final_states, outs = chees_segment(
                    states, keys, jnp.asarray(0, jnp.int32), extras
                )
                return chees_build_result(final_states, extras, outs)

            return jax.jit(chees_program)(rng_key, initial_positions)

        ch_init, ch_segment, ch_finish = chees.warmup_hooks(
            logprob_fn,
            initial_positions.shape[0],
            initial_positions.shape[1],
            max(num_warmup, 1),
            initial_step_size=initial_step_size,
            divergence_threshold=divergence_threshold,
            search_initial_step_size=search_initial_step_size,
            dtype=initial_positions.dtype,
        )

        def chees_wh_init(key, positions):
            states = jax.vmap(lambda q: hmc.new_state(q, logprob_fn))(
                positions
            )
            warmup_key, sample_key = jax.random.split(key)
            return ch_init(warmup_key, states), sample_key

        def chees_wh_segment(wcarry, steps):
            wcarry, _ = ch_segment(wcarry, steps)
            return wcarry

        def chees_wh_finish(wcarry):
            result = ch_finish(wcarry)
            extras = (
                result.step_size,
                result.trajectory_length,
                result.inverse_mass_matrix,
            )
            return result.states, extras

        def chees_wh_place(wcarry):
            if mesh is None:
                return wcarry
            key, states, da, adam, log_h, wc, imm = wcarry
            rep = replicated(mesh)
            return (
                jax.device_put(key, rep),
                jax.device_put(states, chain_sharding(mesh)),
                jax.device_put(da, rep),
                jax.device_put(adam, rep),
                jax.device_put(log_h, rep),
                jax.device_put(wc, rep),
                jax.device_put(imm, rep),
            )

        return _checkpointed_run(
            rng_key, initial_positions, chees_warmup_program,
            chees_segment, chees_build_result, num_samples,
            checkpoint_every, checkpoint_path, resume, collect_positions,
            mesh, _crash_after_segments,
            warmup_hooks=(
                chees_wh_init, chees_wh_segment, chees_wh_finish,
                chees_wh_place,
            ),
            num_warmup=max(num_warmup, 1),
            _crash_after_warmup_segments=_crash_after_warmup_segments,
        )

    if algorithm == "mala" and is_mass_matrix_full:
        raise ValueError(
            "MALA supports scalar/diagonal preconditioners only; "
            "is_mass_matrix_full=True is not compatible with algorithm='mala'"
        )
    from aehmc_tpu.sampling import make_kernel, new_sampler_state

    kernel = make_kernel(
        logprob_fn,
        algorithm,
        num_integration_steps=num_integration_steps,
        max_num_expansions=max_num_expansions,
        divergence_threshold=divergence_threshold,
    )

    if mesh is None and len(jax.devices()) > 1:
        mesh = make_mesh()
    if mesh is not None:
        sharding = chain_sharding(mesh)
        initial_positions = jax.device_put(initial_positions, sharding)

    num_chains = initial_positions.shape[0]

    def warmup_program(key, positions):
        init_key, warmup_key, sample_key = jax.random.split(key, 3)
        init_keys = jax.random.split(init_key, num_chains)
        states = jax.vmap(
            lambda k, q: new_sampler_state(algorithm, k, q, logprob_fn)
        )(init_keys, positions)
        if num_warmup > 0:
            states, (eps, imm), _ = pooled_warmup(
                warmup_key,
                kernel,
                states,
                num_warmup,
                is_mass_matrix_full=is_mass_matrix_full,
                initial_step_size=initial_step_size,
                target_acceptance_rate=target_acceptance_rate,
                search_initial_step_size=search_initial_step_size,
                per_chain_step_size=per_chain_step_size,
            )
        else:
            dtype = positions.dtype
            eps = jnp.asarray(initial_step_size, dtype)
            if per_chain_step_size:
                eps = jnp.full((num_chains,), initial_step_size, dtype)
            dim = 0 if positions.ndim == 1 else positions.shape[1]
            if is_mass_matrix_full and dim > 0:
                imm = jnp.identity(dim, dtype)
            elif dim > 0:
                imm = jnp.ones((dim,), dtype)
            else:
                imm = jnp.ones((), dtype)
        return states, (eps, imm), sample_key

    def sample_segment(states, keys, seg_start, extras):
        eps, imm = extras

        def one_step(states, key):
            keys = jax.random.split(key, num_chains)
            if per_chain_step_size:
                new_states, infos = jax.vmap(
                    lambda k, s, e: kernel(k, s, e, imm)
                )(keys, states, eps)
            else:
                new_states, infos = jax.vmap(
                    lambda k, s: kernel(k, s, eps, imm)
                )(keys, states)
            out = new_states.position if collect_positions else None
            return new_states, (out, infos)

        return jax.lax.scan(one_step, states, keys)

    def build_result(states, extras, outs):
        eps, imm = extras
        positions_out, infos = outs
        return SampleResult(
            final_state=states,
            positions=positions_out if collect_positions else None,
            diagnostics=infos,
            step_size=eps,
            inverse_mass_matrix=imm,
        )

    if not checkpoint_every:

        def program(key, positions):
            states, extras, sample_key = warmup_program(key, positions)
            keys = jax.random.split(sample_key, num_samples)
            final_states, outs = sample_segment(
                states, keys, jnp.asarray(0, jnp.int32), extras
            )
            return build_result(final_states, extras, outs)

        return jax.jit(program)(rng_key, initial_positions)

    warmup_hooks = None
    if num_warmup > 0:
        w_init, w_segment, w_finish = pooled_warmup_hooks(
            kernel,
            num_chains,
            num_warmup,
            is_mass_matrix_full=is_mass_matrix_full,
            initial_step_size=initial_step_size,
            target_acceptance_rate=target_acceptance_rate,
            search_initial_step_size=search_initial_step_size,
        )

        def wh_init(key, positions):
            init_key, warmup_key, sample_key = jax.random.split(key, 3)
            init_keys = jax.random.split(init_key, num_chains)
            states = jax.vmap(
                lambda k, q: new_sampler_state(algorithm, k, q, logprob_fn)
            )(init_keys, positions)
            return w_init(warmup_key, states), sample_key

        def wh_segment(wcarry, steps):
            wcarry, _ = w_segment(wcarry, steps)
            return wcarry

        def wh_place(wcarry):
            if mesh is None:
                return wcarry
            key, states, ast = wcarry
            return (
                jax.device_put(key, replicated(mesh)),
                jax.device_put(states, chain_sharding(mesh)),
                jax.device_put(ast, replicated(mesh)),
            )

        warmup_hooks = (wh_init, wh_segment, w_finish, wh_place)

    return _checkpointed_run(
        rng_key,
        initial_positions,
        warmup_program,
        sample_segment,
        build_result,
        num_samples,
        checkpoint_every,
        checkpoint_path,
        resume,
        collect_positions,
        mesh,
        _crash_after_segments,
        warmup_hooks=warmup_hooks,
        num_warmup=num_warmup,
        _crash_after_warmup_segments=_crash_after_warmup_segments,
    )


def _checkpointed_run(
    rng_key,
    initial_positions,
    warmup_program,
    sample_segment,
    build_result,
    num_samples,
    checkpoint_every,
    checkpoint_path,
    resume,
    collect_positions,
    mesh,
    _crash_after_segments,
    warmup_hooks=None,
    num_warmup=0,
    _crash_after_warmup_segments=None,
    place_carry=None,
):
    """Segmented sampling loop with periodic snapshots (SURVEY.md §5).

    ``warmup_program(key, positions) -> (carry, extras, sample_key)``;
    ``sample_segment(carry, keys, seg_start, extras) -> (carry, outs)``
    with ``outs`` any pytree of per-draw stacked arrays;
    ``build_result(carry, extras, outs) -> SampleResult``.

    Sampling runs as ``ceil(num_samples / checkpoint_every)`` jitted scans.
    The per-draw keys for the WHOLE run are derived once from the
    post-warmup key, so a resumed run replays the exact key stream of the
    uninterrupted one; per-segment computations are the same compiled
    program on the same inputs, hence bitwise-identical results.

    **Warmup checkpointing**: pass ``warmup_hooks = (init, segment,
    finish, place)`` with ``init(key, positions) -> (wcarry,
    sample_key)``, ``segment(wcarry, steps) -> wcarry`` over absolute
    step indices, ``finish(wcarry) -> (carry, extras)``, and
    ``place(wcarry) -> wcarry`` pinning the carry's device placement
    (chain-sharded states, replicated adaptation state).  Warmup then also runs in
    ``checkpoint_every``-step segments, snapshotting the warmup carry to
    ``<checkpoint_path minus .npz>_warmup.npz`` — a run killed mid-warmup
    resumes from the last warmup snapshot instead of restarting.  The
    hooks thread the PRNG key through the carry, so the segmented warmup
    is bitwise identical to the single-scan one.
    """
    import os

    import numpy as np

    from aehmc_tpu import checkpoint as ckpt

    if not checkpoint_path.endswith(".npz"):
        # A directory path would route to Orbax's StandardCheckpointer,
        # which validates restore shapes against the example pytree — and
        # the resume example below can't know the saved `outs` length
        # before restoring.  The .npz backend is shape-agnostic (it
        # restores whatever was saved), so driver-level checkpointing
        # requires it; Orbax remains available for user-level state
        # snapshots via aehmc_tpu.checkpoint.
        raise ValueError(
            "driver-level checkpointing requires an .npz checkpoint_path "
            f"(got {checkpoint_path!r})"
        )
    segment_fn = jax.jit(sample_segment)
    n_segments = -(-num_samples // checkpoint_every)
    warmup_path = checkpoint_path[: -len(".npz")] + "_warmup.npz"

    done_segments = 0
    out_chunks = []
    if resume and os.path.exists(checkpoint_path):
        # Build a dtype-correct example pytree without running anything:
        # eval_shape gives the exact structure/dtypes of warmup + segments.
        wu_shapes = jax.eval_shape(
            warmup_program, rng_key, initial_positions
        )
        carry_ex, extras_ex, key_ex = jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), wu_shapes
        )
        first = min(checkpoint_every, num_samples)
        keys_ex = jax.random.split(jax.random.PRNGKey(0), first)
        seg_shapes = jax.eval_shape(
            sample_segment, carry_ex, keys_ex,
            jnp.zeros((), jnp.int32), extras_ex,
        )
        _, outs_ex = jax.tree_util.tree_map(
            lambda s: jnp.zeros((0,) + s.shape[1:], s.dtype), seg_shapes
        )
        example = {
            "carry": carry_ex,
            "extras": extras_ex,
            "sample_key": key_ex,
            "done_segments": jnp.zeros((), jnp.int32),
            "outs": outs_ex,
        }
        loaded = ckpt.restore(checkpoint_path, example)
        carry, extras = loaded["carry"], loaded["extras"]
        sample_key = loaded["sample_key"]
        done_segments = int(loaded["done_segments"])
        out_chunks = [loaded["outs"]]
        if mesh is not None:
            # Re-pin the restored carry's placement (the full run's
            # segments saw these shardings); families whose carry mixes
            # chain-major and replicated leaves supply place_carry.
            if place_carry is not None:
                carry = place_carry(carry)
            else:
                carry = jax.device_put(carry, chain_sharding(mesh))
    elif warmup_hooks is not None and num_warmup > 0:
        wh_init, wh_segment, wh_finish, wh_place = warmup_hooks
        wseg_fn = jax.jit(
            lambda wcarry, steps: wh_segment(wcarry, steps)
        )
        done_wsteps = 0
        if resume and os.path.exists(warmup_path):
            wi_shapes = jax.eval_shape(
                wh_init, rng_key, initial_positions
            )
            wcarry_ex, wkey_ex = jax.tree_util.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype), wi_shapes
            )
            wexample = {
                "wcarry": wcarry_ex,
                "sample_key": wkey_ex,
                "done_steps": jnp.zeros((), jnp.int32),
            }
            wloaded = ckpt.restore(warmup_path, wexample)
            wcarry = wloaded["wcarry"]
            sample_key = wloaded["sample_key"]
            done_wsteps = int(wloaded["done_steps"])
        else:
            wcarry, sample_key = jax.jit(wh_init)(
                rng_key, initial_positions
            )
        # Canonical placement after BOTH init and restore: segment
        # compilations then see identical input shardings in the
        # uninterrupted and the resumed process, which is what makes the
        # two bitwise-identical (a restored, unplaced carry would compile
        # a differently-partitioned — hence differently-rounded — step).
        wcarry = wh_place(wcarry)
        wsegs_run = 0
        for lo in range(done_wsteps, num_warmup, checkpoint_every):
            hi = min(lo + checkpoint_every, num_warmup)
            wcarry = wseg_fn(wcarry, jnp.arange(lo, hi, dtype=jnp.int32))
            ckpt.save(
                warmup_path,
                {
                    "wcarry": wcarry,
                    "sample_key": sample_key,
                    "done_steps": jnp.asarray(hi, jnp.int32),
                },
            )
            wsegs_run += 1
            if (
                _crash_after_warmup_segments is not None
                and wsegs_run >= _crash_after_warmup_segments
                and hi < num_warmup
            ):
                return None  # simulated kill mid-warmup (test hook)
        carry, extras = jax.jit(wh_finish)(wcarry)
    else:
        carry, extras, sample_key = jax.jit(warmup_program)(
            rng_key, initial_positions
        )

    all_keys = jax.random.split(sample_key, num_samples)

    def _stack(chunks):
        if len(chunks) == 1:
            return chunks[0]
        return jax.tree_util.tree_map(
            lambda *xs: np.concatenate([np.asarray(x) for x in xs]), *chunks
        )

    for seg in range(done_segments, n_segments):
        lo = seg * checkpoint_every
        hi = min(lo + checkpoint_every, num_samples)
        carry, outs = segment_fn(
            carry, all_keys[lo:hi], jnp.asarray(lo, jnp.int32), extras
        )
        out_chunks.append(outs)
        payload = {
            "carry": carry,
            "extras": extras,
            "sample_key": sample_key,
            "done_segments": jnp.asarray(seg + 1, jnp.int32),
            "outs": _stack(out_chunks),
        }
        ckpt.save(checkpoint_path, payload)
        if (
            _crash_after_segments is not None
            and seg + 1 - done_segments >= _crash_after_segments
            and seg + 1 < n_segments
        ):
            return None  # simulated kill (test hook)

    return build_result(carry, extras, _stack(out_chunks))
