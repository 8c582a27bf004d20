"""The front-door sampling API: one call, every algorithm, every path.

The reference leaves the outer sampling loop (and everything above it)
to user code — an Aesara ``scan`` plus ``aesara.function`` compilation
(ref tests/test_hmc.py:314-327, examples/LinearRegression.ipynb).  This
framework's pitch is that it shouldn't: :func:`sample` is a single entry
point that dispatches across the two execution paths

- **xla** — the generic JAX kernels, one chain (1-D position) or an
  independently-warmed chain batch,
- **pooled** — a chain batch with pooled cross-chain adaptation, the
  chain axis sharded over a ``jax.sharding.Mesh`` (the default for 2-D
  positions),

and across the six algorithms (``nuts``, ``hmc``, ``chees``, ``meads``,
``ghmc``, ``mala``), returning one :class:`~aehmc_tpu.sampling.SampleResult`
shape regardless of the route taken.

Both paths compile to plain XLA.  Hand-written Pallas kernels for the
NUTS, ChEES and GHMC transitions were measured against these paths on an
NVIDIA H100 and lost end to end (PERF.md), so there is no kernel route.
"""

from typing import Callable

import jax
import jax.numpy as jnp

from aehmc_tpu import sampling
from aehmc_tpu.sampling import SampleResult

ALGORITHMS = ("nuts", "hmc", "chees", "meads", "ghmc", "mala")
PATHS = ("auto", "xla", "pooled")


def _resolve_path(path, initial_position):
    if path not in PATHS:
        raise ValueError(
            f"path must be one of {PATHS}, got {path!r} (there is no "
            "kernel route: the measured XLA paths are faster)"
        )
    if path != "auto":
        return path
    if jnp.ndim(initial_position) <= 1:
        return "xla"
    return "pooled"


def sample(
    rng_key: jax.Array,
    logprob_fn: Callable,
    initial_position: jax.Array,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    *,
    algorithm: str = "nuts",
    path: str = "auto",
    mesh=None,
    **kwargs,
) -> SampleResult:
    """Sample from ``logprob_fn`` — warmup + sampling in one call.

    Parameters
    ----------
    rng_key
        A ``jax.random`` key.  Everything downstream is counter-based —
        the same key reproduces the run bit for bit.
    logprob_fn
        ``position -> scalar log density`` (the reference's model
        contract, ref README.md:35-37).
    initial_position
        ``(dim,)`` runs ONE chain on the XLA path; ``(chains, dim)``
        runs a chain batch (pooled cross-chain adaptation by default).
    num_samples, num_warmup
        Draws to return / warmup transitions (Stan window adaptation;
        for ``meads`` warmup is burn-in only — adaptation is part of
        the kernel).
    algorithm
        One of ``nuts | hmc | chees | meads | ghmc | mala``.
    path
        ``auto`` (default) picks: 1-D position → ``xla``; 2-D →
        ``pooled``.  ``xla`` with a 2-D position runs independently
        warmed chains (``chees``/``meads`` are ensemble methods and
        always pool).
    mesh
        A ``jax.sharding.Mesh`` to shard the chain axis over (pooled
        path; by default every attached device).
    **kwargs
        Forwarded to the chosen driver (e.g. ``per_chain_step_size``,
        ``checkpoint_every``/``checkpoint_path``/``resume``,
        ``max_num_expansions``, ``target_acceptance_rate``,
        ``meads_recompute_every``).

    Returns
    -------
    SampleResult
        ``(final_state, positions, diagnostics, step_size,
        inverse_mass_matrix)`` with ``positions`` of shape
        ``(draws, dim)`` (single chain) or ``(draws, chains, dim)``
        (pooled batch; independent XLA chains stack
        ``(chains, draws, dim)``).
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}"
        )
    route = _resolve_path(path, initial_position)

    if route == "xla":
        if jnp.ndim(initial_position) <= 1:
            if algorithm in ("chees", "meads"):
                raise ValueError(
                    f"{algorithm!r} is a chain-ensemble method (cross-chain "
                    "adaptation); pass a (chains, dim) initial_position"
                )
            return sampling.sample(
                rng_key, logprob_fn, initial_position,
                num_samples, num_warmup, algorithm=algorithm, **kwargs,
            )
        if algorithm not in ("chees", "meads"):
            return sampling.sample_chains(
                rng_key, logprob_fn, initial_position,
                num_samples, num_warmup, algorithm=algorithm, **kwargs,
            )
        # ensemble methods have no independent-chain mode; their XLA
        # route IS the pooled driver

    if jnp.ndim(initial_position) != 2:
        raise ValueError(
            f"path={route!r} needs a (chains, dim) initial_position, got "
            f"shape {jnp.shape(initial_position)}"
        )

    from aehmc_tpu.parallel.pooled import sample_sharded

    return sample_sharded(
        rng_key, logprob_fn, initial_position,
        num_samples, num_warmup,
        algorithm=algorithm, mesh=mesh, **kwargs,
    )
