"""MEADS: Maximum-Eigenvalue Adaptation of Damping and Step size.

Tuning-free generalized HMC following Hoffman & Sountsov (2022, AISTATS
"Tuning-Free Generalized Hamiltonian Monte Carlo").  New capability beyond
the reference (which has no adaptive GHMC; ref has only DA window adaptation,
ref window_adaptation.py) and a natural fleet-scale sampler for large chain
batches: like ChEES it is trajectory-regular (every chain does exactly one
leapfrog step per transition — zero per-chain control flow, no straggler
lanes), and it removes dual averaging entirely.

Scheme
------
Chains are split into ``num_folds`` folds.  Every iteration, fold ``k``'s
hyperparameters are **recomputed from the current states of fold k-1**:

- diagonal preconditioner ``sigma_d``: the cross-chain standard deviation of
  position component ``d`` (the GHMC inverse mass matrix is ``sigma^2``);
- step size ``eps = 0.5 / sqrt(lmax(cov(sigma * grad)))``: for a Gaussian
  target the covariance of preconditioned gradients equals the
  preconditioned precision, whose largest eigenvalue is the stiffest
  curvature; the leapfrog stability limit is ``2/sqrt(lmax)``, so the 0.5
  factor keeps a 4x margin;
- damping ``gamma = eps / sqrt(max(lmax(cov(position / sigma)), 1))``: one
  step length divided by the longest preconditioned length scale, i.e. the
  momentum decorrelates on the timescale of the slowest mode; the momentum
  retention is ``alpha = exp(-2 * gamma)`` (an OU half-step discretization,
  always in (0, 1)).

Because fold ``k``'s parameters never depend on fold ``k``'s own state, each
fold's transition is a valid Markov kernel given the rest — adaptation can
run forever, so there is no warmup/sampling phase boundary (``num_warmup``
in the drivers is just discarded burn-in).

Largest eigenvalues are computed by a fixed-iteration matrix-free power
iteration (deterministic, O(chains * dim) per iteration); the paper uses a
cheaper trace-ratio estimate — the power iteration is tighter and its cost
is negligible next to the gradient.

All cross-chain reductions are means/matmuls over the chain axis: sharded
over a mesh they lower to cross-device collectives.
"""

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu import ghmc
from aehmc_tpu.algorithms import (
    _pairwise_outer_sum,
    pairwise_mean,
    pairwise_sum,
)
from aehmc_tpu.types import Diagnostics, IntegratorState

# Below this dimension the (dim, dim) covariance is formed explicitly
# (one chunked Gram matrix product) and the power iteration runs on it —
# d*d matvecs instead of 2 * num_iters full passes over the (chains, dim)
# batch.  Above it, fall back to the matrix-free contraction.
_EXPLICIT_COV_MAX_DIM = 512


class MeadsHyperparams(NamedTuple):
    """Per-fold hyperparameters (recomputed every ``recompute_every``
    iterations)."""

    step_size: jax.Array  # (num_folds,)
    alpha: jax.Array  # (num_folds,) momentum retention
    inverse_mass_matrix: jax.Array  # (num_folds, dim) = sigma^2


class MeadsCarry(NamedTuple):
    """Scan carry of the MEADS kernel: chain states, the hyperparameters
    in force, and the iteration counter that schedules re-estimation."""

    states: IntegratorState  # batched over the chain axis
    hyper: MeadsHyperparams
    step: jax.Array  # scalar int32


def _lmax_cov(
    x: jax.Array, num_iters: int = 16, center: bool = True
) -> jax.Array:
    """Largest eigenvalue of the covariance (or, with ``center=False``, the
    uncentered second moment) of ``x`` (rows = samples).

    Deterministic all-ones start; every over-chains contraction uses a
    fixed reduction order (pairwise tree / fixed-chunk Gram) so estimated
    hyperparameters are bitwise mesh-shape-invariant.  For
    dim <= ``_EXPLICIT_COV_MAX_DIM`` the (dim, dim) second-moment matrix
    is formed once with a chunked matrix product and the power iteration runs
    on it (O(n d^2) once + O(num_iters d^2)); otherwise the iteration is
    matrix-free (O(num_iters n d)).
    """
    if center:
        x = x - pairwise_mean(x, axis=0)
    n = x.shape[0]
    dim = x.shape[1]
    v0 = jnp.ones((dim,), x.dtype) / jnp.sqrt(jnp.asarray(dim, x.dtype))

    if dim <= _EXPLICIT_COV_MAX_DIM:
        cov = _pairwise_outer_sum(x) / n

        def matvec(v):
            return cov @ v

    else:

        def matvec(v):
            # (x @ v) reduces over dim (unsharded); the chain-axis
            # contraction x.T @ w is a pairwise-ordered weighted row sum.
            w = x @ v
            return pairwise_sum(w[:, None] * x, axis=0) / n

    def body(_, v):
        w = matvec(v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-20)

    v = jax.lax.fori_loop(0, num_iters, body, v0)
    w = matvec(v)
    return jnp.maximum(jnp.vdot(v, w).real.astype(x.dtype), 1e-20)


def estimate_hyperparams(
    states: IntegratorState,
    num_folds: int = 4,
    step_size_multiplier: float = 0.5,
) -> MeadsHyperparams:
    """Cross-fold hyperparameter estimation (fold k from fold k-1)."""
    num_chains, dim = states.position.shape
    per_fold = num_chains // num_folds

    def fold(a):
        return a.reshape((num_folds, per_fold) + a.shape[1:])

    # Fold k's estimators come from fold k-1's current states.
    est_pos = jnp.roll(fold(states.position), 1, axis=0)
    est_grad = jnp.roll(fold(states.potential_energy_grad), 1, axis=0)

    def fold_params(pos, grad):
        pos_mean = pairwise_mean(pos, axis=0)
        std = jnp.sqrt(pairwise_mean((pos - pos_mean) ** 2, axis=0))
        # Coincident chains (e.g. every chain initialized at the same
        # point) have zero cross-chain variance: fall back to the
        # identity preconditioner per dimension instead of ~0, which
        # would send eps to infinity and freeze the fleet in permanent
        # divergence.
        degenerate = std <= 1e-10 * (1.0 + jnp.abs(pos_mean))
        sigma = jnp.where(degenerate, 1.0, std)
        # Uncentered second moment of the preconditioned gradients: equal
        # to the covariance at stationarity (E[grad] = 0) but still a
        # useful curvature scale when chains coincide (cov would be 0).
        eps = step_size_multiplier / jnp.sqrt(
            _lmax_cov(grad * sigma, center=False)
        )
        length = jnp.sqrt(jnp.maximum(_lmax_cov(pos / sigma), 1.0))
        gamma = eps / length
        alpha = jnp.exp(-2.0 * gamma)
        return MeadsHyperparams(
            step_size=eps, alpha=alpha, inverse_mass_matrix=sigma**2
        )

    return jax.vmap(fold_params)(est_pos, est_grad)


def init_carry(
    rng_key: jax.Array,
    initial_positions: jax.Array,
    logprob_fn: Callable,
    num_folds: int = 4,
    step_size_multiplier: float = 0.5,
) -> MeadsCarry:
    """Initial :class:`MeadsCarry`: batched GHMC states + first estimate."""
    states = init_states(rng_key, initial_positions, logprob_fn)
    hyper = estimate_hyperparams(states, num_folds, step_size_multiplier)
    return MeadsCarry(
        states=states, hyper=hyper, step=jnp.asarray(0, jnp.int32)
    )


def new_kernel(
    logprob_fn: Callable,
    num_folds: int = 4,
    divergence_threshold: float = 1000.0,
    step_size_multiplier: float = 0.5,
    recompute_every: int = 1,
) -> Callable:
    """Build the MEADS transition over a full chain batch.

    Returns ``step(rng_key, carry) -> (carry, infos)`` where ``carry`` is
    a :class:`MeadsCarry` whose states are batched over a leading chain
    axis divisible by ``num_folds`` (>= 2 chains per fold so the
    cross-chain std is defined).  Build the initial carry with
    :func:`init_carry`.

    ``recompute_every=k`` re-estimates the hyperparameters every k-th
    iteration instead of every iteration, amortizing the estimation cost
    (the eigenvalue estimates are the only non-leapfrog work in the
    kernel).  Validity is unchanged: fold k's parameters remain a
    function of the OTHER folds' (past) trajectory and never of fold k's
    own current state — the same complementary-fold argument as the
    per-step scheme (Hoffman & Sountsov 2022), just with a stale-by-at-
    most-k snapshot.  Statistical gates (tests/test_meads.py) pin the
    posterior for both settings.
    """
    transition = _make_fold_transition(logprob_fn, divergence_threshold)

    def step(
        rng_key: jax.Array, carry: MeadsCarry
    ) -> Tuple[MeadsCarry, Diagnostics]:
        states = carry.states
        num_chains = states.position.shape[0]
        per_fold = num_chains // num_folds

        def fold(a):
            return a.reshape((num_folds, per_fold) + a.shape[1:])

        def unfold(a):
            return a.reshape((num_chains,) + a.shape[2:])

        if recompute_every == 1:
            hyper = estimate_hyperparams(
                states, num_folds, step_size_multiplier
            )
        else:
            hyper = jax.lax.cond(
                carry.step % recompute_every == 0,
                lambda: estimate_hyperparams(
                    states, num_folds, step_size_multiplier
                ),
                lambda: carry.hyper,
            )

        fold_states = jax.tree_util.tree_map(fold, states)
        new_fold_states, infos = transition(rng_key, fold_states, hyper)
        new_states = jax.tree_util.tree_map(unfold, new_fold_states)
        infos = jax.tree_util.tree_map(unfold, infos)
        return (
            MeadsCarry(
                states=new_states, hyper=hyper, step=carry.step + 1
            ),
            infos,
        )

    return step


def _make_fold_transition(
    logprob_fn: Callable, divergence_threshold: float = 1000.0
) -> Callable:
    """One GHMC sweep over FOLDED states with fixed hyperparameters.

    ``transition(rng_key, fold_states, hyper)`` with ``fold_states``
    batched (num_folds, per_fold, ...).  Bulk randomness: ONE normal
    draw for the whole fleet's refresh innovations and one uniform for
    the MH coins, instead of vmapping per-chain key splits + draws (a
    measurable fraction of the single leapfrog this kernel runs per
    transition).
    """
    ghmc_step = ghmc.new_noise_kernel(logprob_fn, divergence_threshold)

    def transition(rng_key, fold_states, hyper):
        num_folds, per_fold, dim = fold_states.position.shape
        dtype = fold_states.position.dtype
        noise_key, accept_key = jax.random.split(rng_key)
        fold_z = jax.random.normal(
            noise_key, (num_folds, per_fold, dim), dtype
        )
        fold_u = jax.random.uniform(
            accept_key, (num_folds, per_fold), dtype
        )

        def run_fold(z_f, u_f, states_f, eps_f, alpha_f, imm_f):
            # noise ~ N(0, M) for diagonal M^{-1}: scale by sqrt(1/M^{-1})
            noise_f = jnp.sqrt(1.0 / imm_f)[None, :] * z_f
            return jax.vmap(
                lambda n, u, s: ghmc_step(n, u, s, eps_f, alpha_f, imm_f)
            )(noise_f, u_f, states_f)

        return jax.vmap(run_fold)(
            fold_z,
            fold_u,
            fold_states,
            hyper.step_size,
            hyper.alpha,
            hyper.inverse_mass_matrix,
        )

    return transition


def init_states(
    rng_key: jax.Array, initial_positions: jax.Array, logprob_fn: Callable
) -> IntegratorState:
    """Batched GHMC states (unit momenta; MEADS re-preconditions each step)."""
    keys = jax.random.split(rng_key, initial_positions.shape[0])
    return jax.vmap(lambda k, q: ghmc.new_state(k, q, logprob_fn))(
        keys, initial_positions
    )


def sample(
    rng_key: jax.Array,
    logprob_fn: Callable,
    initial_positions: jax.Array,
    num_samples: int = 1000,
    num_warmup: int = 500,
    *,
    num_folds: int = 4,
    divergence_threshold: float = 1000.0,
    step_size_multiplier: float = 0.5,
    collect_positions: bool = True,
    recompute_every: int = 1,
):
    """Burn-in + sampling, one jitted program.

    ``initial_positions``: (chains, dim) with chains divisible by
    ``num_folds`` and at least 2 chains per fold.  Adaptation runs through
    both phases (it is part of the kernel); ``num_warmup`` draws are simply
    discarded.  ``recompute_every`` amortizes hyperparameter estimation
    (see :func:`new_kernel`).

    Returns ``(final_states, positions, infos, hyper)`` with positions
    (draws, chains, dim), ``infos`` a stacked :class:`Diagnostics`, and
    ``hyper`` the final per-fold :class:`MeadsHyperparams`.
    """
    num_chains = initial_positions.shape[0]
    if num_chains % num_folds or num_chains // num_folds < 2:
        raise ValueError(
            f"MEADS needs chains divisible by num_folds={num_folds} with "
            f">= 2 chains per fold, got {num_chains}"
        )
    init_key, warm_key, sample_key = jax.random.split(rng_key, 3)

    if recompute_every > 1:
        return _sample_segmented(
            init_key, warm_key, sample_key,
            logprob_fn, initial_positions, num_samples, num_warmup,
            num_folds=num_folds,
            divergence_threshold=divergence_threshold,
            step_size_multiplier=step_size_multiplier,
            collect_positions=collect_positions,
            recompute_every=recompute_every,
        )

    carry = init_carry(
        init_key, initial_positions, logprob_fn, num_folds,
        step_size_multiplier,
    )
    kernel = new_kernel(
        logprob_fn, num_folds, divergence_threshold, step_size_multiplier,
    )

    def burn_step(carry, key):
        new_carry, _ = kernel(key, carry)
        return new_carry, None

    if num_warmup > 0:
        carry, _ = jax.lax.scan(
            burn_step, carry, jax.random.split(warm_key, num_warmup)
        )

    def draw_step(carry, key):
        new_carry, infos = kernel(key, carry)
        out = (
            new_carry.states.position if collect_positions else None
        )
        return new_carry, (out, infos)

    final_carry, (positions, infos) = jax.lax.scan(
        draw_step, carry, jax.random.split(sample_key, num_samples)
    )
    return final_carry.states, positions, infos, final_carry.hyper


def _sample_segmented(
    init_key, warm_key, sample_key,
    logprob_fn, initial_positions, num_samples, num_warmup, *,
    num_folds, divergence_threshold, step_size_multiplier,
    collect_positions, recompute_every,
):
    """Amortized MEADS as NESTED scans: the outer scan re-estimates the
    hyperparameters once per ``recompute_every``-draw segment, the inner
    scan runs the segment with them FIXED.

    This is the fast shape: the per-step ``lax.cond`` of the carry-based
    kernel costs ~0.24 ms/draw at 10k chains even when the estimation
    branch is not taken (the cond materializes its captured operands);
    hoisting estimation to segment boundaries removes it entirely.  Same
    validity argument as the kernel's ``recompute_every`` (parameters are
    a stale-by-at-most-k function of the other folds' trajectory).
    Segment counts round UP: the last segment may run short.
    """
    num_chains = initial_positions.shape[0]
    per_fold = num_chains // num_folds

    def fold(a):
        return a.reshape((num_folds, per_fold) + a.shape[1:])

    def unfold(a):
        return a.reshape((num_chains,) + a.shape[2:])

    def pad_segments(n):
        return -(-n // recompute_every)

    states = init_states(init_key, initial_positions, logprob_fn)
    fold_states = jax.tree_util.tree_map(fold, states)
    transition = _make_fold_transition(logprob_fn, divergence_threshold)

    def estimate(fold_states):
        flat = jax.tree_util.tree_map(unfold, fold_states)
        return estimate_hyperparams(
            flat, num_folds, step_size_multiplier
        )

    def segment(fold_states, seg_keys, collect):
        hyper = estimate(fold_states)

        def inner(fs, key):
            fs2, infos = transition(key, fs, hyper)
            out = fs2.position if collect else None
            return fs2, (out, infos)

        fold_states, outs = jax.lax.scan(inner, fold_states, seg_keys)
        return fold_states, outs, hyper

    if num_warmup > 0:
        n_wseg = pad_segments(num_warmup)
        wkeys = jax.random.split(warm_key, n_wseg * recompute_every)
        wkeys = wkeys.reshape((n_wseg, recompute_every) + wkeys.shape[1:])

        def warm_outer(fs, seg_keys):
            fs, _, _ = segment(fs, seg_keys, collect=False)
            return fs, None

        fold_states, _ = jax.lax.scan(warm_outer, fold_states, wkeys)

    n_seg = pad_segments(num_samples)
    skeys = jax.random.split(sample_key, n_seg * recompute_every)
    skeys = skeys.reshape((n_seg, recompute_every) + skeys.shape[1:])

    def draw_outer(fs, seg_keys):
        fs, (pos, infos), hyper = segment(
            fs, seg_keys, collect=collect_positions
        )
        return fs, (pos, infos, hyper)

    fold_states, (pos, infos, hypers) = jax.lax.scan(
        draw_outer, fold_states, skeys
    )

    # (n_seg, k, folds, per_fold, ...) -> (draws, chains, ...), trimmed
    # to the requested draw count (the last segment may overrun).
    def flatten(a):
        rest = a.shape[4:]
        a = a.reshape(
            (n_seg * recompute_every, num_chains) + rest
        )
        return a[:num_samples]

    positions = flatten(pos) if collect_positions else None
    infos = jax.tree_util.tree_map(flatten, infos)
    final_states = jax.tree_util.tree_map(unfold, fold_states)
    last_hyper = jax.tree_util.tree_map(lambda a: a[-1], hypers)
    return final_states, positions, infos, last_hyper
