"""Tracing, progress logging, and runtime guards.

Equivalents for the observability the reference delegates to its
host framework (SURVEY.md §5):

- per-transition :class:`~aehmc_tpu.types.Diagnostics` are already first-class
  traced outputs of every kernel (stackable across the sampling scan);
- :func:`progress_callback` streams step / acceptance / divergence counts
  from *inside* a jitted scan via ``jax.debug.callback``;
- :func:`annotate` wraps a phase in a ``jax.profiler`` trace annotation so
  warmup/sampling show up as named spans in a device profile;
- :func:`guard_finite` is the race-detector stand-in (SURVEY.md §5): a
  checkify-style assertion that chain positions stay finite, for tests and
  debugging runs.
"""

import sys
from contextlib import contextmanager
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from aehmc_tpu.types import Diagnostics


def _default_printer(step, acceptance, divergences):
    print(
        f"[aehmc_tpu] step {int(step):>7d}  "
        f"mean acceptance {float(acceptance):.3f}  "
        f"divergent chains {int(divergences)}",
        file=sys.stderr,
        flush=True,
    )


def progress_callback(
    step: jax.Array,
    info: Diagnostics,
    every: int = 100,
    printer: Callable = _default_printer,
) -> None:
    """Emit a progress line every ``every`` steps from inside jitted code.

    Call inside the sampling/warmup scan body; ``info`` may be a single
    chain's Diagnostics or a chain batch (reduced here).
    """
    acceptance = jnp.mean(info.acceptance_probability)
    divergences = jnp.sum(info.is_diverging.astype(jnp.int32))

    def _emit(step, acceptance, divergences):
        printer(step, acceptance, divergences)

    jax.lax.cond(
        step % every == 0,
        lambda: jax.debug.callback(_emit, step, acceptance, divergences),
        lambda: None,
    )


@contextmanager
def annotate(name: str):
    """Named profiler span (shows up in `jax.profiler` device traces)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def guard_finite(state_position: jax.Array, where: str = "chain state"):
    """Debug-mode guard: error out (under checkify) / mark (under jit) when a
    position goes non-finite.  Divergent proposals are *rejected* by design
    (ref proposals.py:43-44), so a non-finite accepted position is a bug.
    """
    ok = jnp.all(jnp.isfinite(state_position))
    jax.lax.cond(
        ok,
        lambda: None,
        lambda: jax.debug.callback(
            partial(_warn_nonfinite, where=where)
        ),
    )
    return ok


def _warn_nonfinite(where: str = "chain state"):
    print(
        f"[aehmc_tpu] WARNING: non-finite values detected in {where}",
        file=sys.stderr,
        flush=True,
    )


def grad_evals_per_sec(infos: Diagnostics, elapsed_seconds: float) -> float:
    """Aggregate the per-transition leapfrog counters into the BASELINE.md
    observability metric."""
    total = jnp.sum(infos.num_integration_steps)
    return float(total) / elapsed_seconds
