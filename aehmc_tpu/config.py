"""Frozen configuration dataclasses and the dtype policy.

The reference has no config system — tunables are keyword arguments with
Stan-derived defaults scattered across modules (SURVEY.md §5: ref hmc.py:46,
nuts.py:20-21, step_size.py:10-13, algorithms.py:18, mass_matrix.py:106-107,
window_adaptation.py:17-24,232-235).  Here the same defaults live in one
place as immutable dataclasses; every driver kwarg defaults to these values,
so ``sample(**asdict-style overrides)`` and plain kwargs stay equivalent.

Dtype policy (SURVEY.md §7 "numerics policy")
---------------------------------------------
- The library is **dtype-polymorphic**: every kernel computes at the dtype
  of the position you hand it and never upcasts.  f32 positions give an f32
  chain (the production accelerator path); f64 positions
  give an f64 chain (requires ``jax.config.update("jax_enable_x64", True)``).
- Energies, log-weights and adaptation statistics are carried at the chain
  dtype.  The statistical test gates (MCSE, KS, warmup quality, exact regime
  counts) pass at BOTH dtypes (tests/test_hmc.py, tests/test_distributional.py,
  tests/test_window_adaptation.py, tests/test_trajectory.py) — no f64
  accumulation is required for correctness on the covered posteriors: NaN/inf
  energies reject rather than crash (proposals NaN→−inf), and dual averaging
  runs in log space where f32 is ample.
- Where f64 *does* matter: dense mass-matrix Cholesky on ill-conditioned
  posteriors (condition number ≳ 1e6 exceeds f32's ~7 digits) — warm up in
  f64 on such targets, or precondition.  On the GPU an f32 matrix product
  may run in TF32 at JAX's default precision; the Metropolis correction is
  exact for the potential as computed.
- PRNG note: ``jax.random.normal`` draws *different* streams at f32 vs f64
  for the same key, so per-seed pinned tests record expectations per dtype.
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DualAveragingConfig:
    """Nesterov dual averaging (ref algorithms.py:17-115, step_size.py:9-13).

    ``target_acceptance_rate`` is Stan's 0.8 default (ref
    window_adaptation.py:24); ``find_reasonable_step_size`` seeds ``mu``
    when the drivers' ``search_initial_step_size=True``.
    """

    target_acceptance_rate: float = 0.8
    gamma: float = 0.05
    t0: int = 10
    kappa: float = 0.75


@dataclass(frozen=True)
class MassMatrixConfig:
    """Welford covariance adaptation with Stan shrinkage
    (ref mass_matrix.py:81-118: ``(n/(n+5))·cov + 1e-3·(5/(n+5))·I``)."""

    is_full: bool = False
    shrinkage_weight: float = 5.0
    shrinkage_scale: float = 1e-3


@dataclass(frozen=True)
class WindowSchedule:
    """Stan's three-phase warmup schedule (ref window_adaptation.py:230-327)."""

    initial_buffer: int = 75
    first_window: int = 25
    final_buffer: int = 50


@dataclass(frozen=True)
class NutsConfig:
    """NUTS transition parameters (ref nuts.py:17-21, hmc.py:46)."""

    max_num_expansions: int = 10
    divergence_threshold: float = 1000.0
    paired_leaves: bool = True


@dataclass(frozen=True)
class HmcConfig:
    """Static-trajectory HMC parameters (ref hmc.py:43-126)."""

    num_integration_steps: int = 32
    divergence_threshold: float = 1000.0


@dataclass(frozen=True)
class WarmupConfig:
    """Full window-adaptation driver defaults (ref window_adaptation.py:17-24)."""

    num_steps: int = 1000
    initial_step_size: float = 1.0
    search_initial_step_size: bool = True
    dual_averaging: DualAveragingConfig = field(
        default_factory=DualAveragingConfig
    )
    mass_matrix: MassMatrixConfig = field(default_factory=MassMatrixConfig)
    schedule: WindowSchedule = field(default_factory=WindowSchedule)


DEFAULTS = WarmupConfig()
