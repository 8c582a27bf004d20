"""High-level sampling drivers.

The reference leaves the outer loop to user code — an Aesara ``scan`` over the
kernel plus ``aesara.function`` compilation (ref tests/test_hmc.py:314-327,
examples/LinearRegression.ipynb).  On an accelerator that loop must live inside the same
compiled program, so it is a first-class API here (SURVEY.md §3.4, §7):

- :func:`sample_loop` — jitted ``lax.scan`` over any kernel, one chain.
- :func:`multi_chain` — vmap a kernel over a leading chain axis with split
  per-chain keys (new capability vs the single-chain reference).
- :func:`sample` — warmup (window adaptation) + sampling in one call, single
  or multi chain.
"""

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from aehmc_tpu import ghmc, hmc, mala, nuts, window_adaptation
from aehmc_tpu.types import ChainState, Diagnostics


class SampleResult(NamedTuple):
    final_state: ChainState
    positions: jax.Array
    diagnostics: Diagnostics
    step_size: jax.Array
    inverse_mass_matrix: jax.Array


def sample_loop(
    rng_key: jax.Array,
    kernel: Callable,
    initial_state: ChainState,
    num_samples: int,
) -> Tuple[ChainState, jax.Array, Diagnostics]:
    """Draw ``num_samples`` with one ``lax.scan``.

    ``kernel(key, state) -> (state, info)`` — close over step size and mass
    matrix with ``functools.partial``.
    """

    def one_step(carry, key):
        state = carry
        state, info = kernel(key, state)
        return state, (state.position, info)

    keys = jax.random.split(rng_key, num_samples)
    final_state, (positions, infos) = jax.lax.scan(
        one_step, initial_state, keys
    )
    return final_state, positions, infos


def multi_chain(kernel: Callable) -> Callable:
    """Vectorize a kernel over a leading chain axis.

    ``kernel(key, state, *params)`` becomes
    ``kernel(keys[chain], states[chain], *params)`` with shared parameters —
    the chain-batch data parallelism the reference lacks (SURVEY.md §2).
    Under ``jit`` with sharded inputs the chain axis distributes over the
    device mesh.
    """

    def vmapped(keys, states, *params):
        return jax.vmap(lambda k, s: kernel(k, s, *params))(keys, states)

    return vmapped


def make_kernel(
    logprob_fn: Callable,
    algorithm: str = "nuts",
    *,
    num_integration_steps: int = 32,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    ghmc_alpha: float = 0.9,
) -> Callable:
    """Build a NUTS-style transition ``kernel(key, state, eps, imm)`` for
    the named algorithm ("nuts", "hmc", "mala", or "ghmc").

    "ghmc" is the one-leapfrog persistent-momentum kernel with fixed
    momentum retention ``ghmc_alpha``; its chain state carries a momentum
    (build it with :func:`new_sampler_state`).  For *adaptive* GHMC use
    ``algorithm="meads"`` in the drivers.
    """
    if algorithm == "nuts":
        return nuts.new_kernel(
            logprob_fn,
            max_num_expansions=max_num_expansions,
            divergence_threshold=divergence_threshold,
        )
    if algorithm == "hmc":
        base = hmc.new_kernel(logprob_fn, divergence_threshold)
        return lambda key, state, eps, imm: base(
            key, state, eps, imm, num_integration_steps
        )
    if algorithm == "mala":
        return mala.new_kernel(logprob_fn, divergence_threshold)
    if algorithm == "ghmc":
        base = ghmc.new_kernel(logprob_fn, divergence_threshold)
        alpha = jnp.asarray(ghmc_alpha)
        return lambda key, state, eps, imm: base(key, state, eps, alpha, imm)
    raise ValueError(f"Unknown algorithm: {algorithm!r}")


def new_sampler_state(
    algorithm: str,
    rng_key: jax.Array,
    initial_position: jax.Array,
    logprob_fn: Callable,
):
    """Initial chain state for the named algorithm.

    GHMC carries a persistent momentum (needs a key); every other kernel
    refreshes momentum per transition and starts from a plain ChainState.
    """
    if algorithm == "ghmc":
        return ghmc.new_state(rng_key, initial_position, logprob_fn)
    return hmc.new_state(initial_position, logprob_fn)


def sample(
    rng_key: jax.Array,
    logprob_fn: Callable,
    initial_position: jax.Array,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    *,
    algorithm: str = "nuts",
    num_integration_steps: int = 32,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    search_initial_step_size: bool = True,
    ghmc_alpha: float = 0.9,
    step_size: Optional[float] = None,
    inverse_mass_matrix: Optional[jax.Array] = None,
) -> SampleResult:
    """Warmup + sampling in one call, on one chain or a batch of chains.

    Runs one chain (use :func:`sample_chains` for a chain batch).  Passing
    ``step_size`` and/or ``inverse_mass_matrix`` skips warmup and uses the
    given value(s); a missing one takes its default
    (``initial_step_size`` / identity).
    """
    if algorithm == "mala" and is_mass_matrix_full:
        raise ValueError(
            "MALA supports scalar/diagonal preconditioners only; "
            "is_mass_matrix_full=True is not compatible with algorithm='mala'"
        )
    kernel = make_kernel(
        logprob_fn,
        algorithm,
        num_integration_steps=num_integration_steps,
        max_num_expansions=max_num_expansions,
        divergence_threshold=divergence_threshold,
        ghmc_alpha=ghmc_alpha,
    )

    init_key, warmup_key, sample_key = jax.random.split(rng_key, 3)
    initial_state = new_sampler_state(
        algorithm, init_key, initial_position, logprob_fn
    )

    def _default_imm():
        ndim = initial_position.ndim
        if is_mass_matrix_full and ndim > 0:
            return jnp.identity(
                initial_position.shape[0], initial_position.dtype
            )
        if ndim > 0:
            return jnp.ones_like(initial_position)
        return jnp.ones((), initial_position.dtype)

    if step_size is None and inverse_mass_matrix is None and num_warmup > 0:
        state, (eps, imm), _ = window_adaptation.run(
            warmup_key,
            kernel,
            initial_state,
            num_warmup,
            is_mass_matrix_full=is_mass_matrix_full,
            initial_step_size=initial_step_size,
            target_acceptance_rate=target_acceptance_rate,
            search_initial_step_size=search_initial_step_size,
        )
    else:
        # Explicitly provided tuning parameters are always honored; a
        # missing one falls back to its default.  (Passing either skips
        # warmup.)
        state = initial_state
        eps = jnp.asarray(
            initial_step_size if step_size is None else step_size,
            initial_position.dtype,
        )
        imm = (
            _default_imm()
            if inverse_mass_matrix is None
            else jnp.asarray(inverse_mass_matrix, initial_position.dtype)
        )

    bound_kernel = lambda key, s: kernel(key, s, eps, imm)  # noqa: E731
    final_state, positions, infos = sample_loop(
        sample_key, bound_kernel, state, num_samples
    )
    return SampleResult(
        final_state=final_state,
        positions=positions,
        diagnostics=infos,
        step_size=eps,
        inverse_mass_matrix=imm,
    )


def sample_chains(
    rng_key: jax.Array,
    logprob_fn: Callable,
    initial_positions: jax.Array,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    **kwargs,
) -> SampleResult:
    """Run one independent chain per row of ``initial_positions``.

    Each chain warms up and samples with its own key; results are stacked on
    a leading chain axis.  For pooled cross-chain adaptation and mesh
    sharding use :mod:`aehmc_tpu.parallel`.
    """
    num_chains = initial_positions.shape[0]
    keys = jax.random.split(rng_key, num_chains)
    run_one = partial(
        sample,
        logprob_fn=logprob_fn,
        num_samples=num_samples,
        num_warmup=num_warmup,
        **kwargs,
    )
    return jax.vmap(lambda k, q: run_one(k, initial_position=q))(
        keys, initial_positions
    )
