"""aehmc_tpu: a chain-batched HMC/NUTS sampling framework in JAX.

A ground-up re-design of the capabilities of ``aesara-devs/aehmc`` for
accelerators (the package name is historical; it runs on an NVIDIA GPU):

- pure-functional kernels over pytrees with explicit counter-based PRNG keys
  (replaces the reference's RandomStream + shared-variable ``updates`` dicts,
  e.g. ref hmc.py:123, README.md:49-51),
- all control flow lowered to XLA (``lax.while_loop`` / ``lax.scan`` /
  ``lax.cond``) so a whole warmup+sampling run is a single compiled program,
- first-class multi-chain execution: ``vmap`` over a chain axis, sharded over
  a ``jax.sharding.Mesh`` with cross-chain pooled adaptation (a capability
  the single-chain reference lacks),
- a float64 NumPy NUTS oracle (``ops``) that checks the transitions.

Public modules mirror the reference layout module-for-module
(``integrators``, ``metrics``, ``proposals``, ``termination``, ``trajectory``,
``hmc``, ``nuts``, ``algorithms``, ``step_size``, ``mass_matrix``,
``window_adaptation``, ``utils``) plus new subsystems
(``sampling``, ``diagnostics``, ``parallel``, ``models``, ``ops``).
"""

__version__ = "0.1.0"

from aehmc_tpu import (  # noqa: F401
    algorithms,
    checkpoint,
    chees,
    config,
    diagnostics,
    ghmc,
    hmc,
    mala,
    meads,
    integrators,
    mass_matrix,
    metrics,
    models,
    nuts,
    observability,
    proposals,
    sampling,
    step_size,
    termination,
    trajectory,
    utils,
    window_adaptation,
)
from aehmc_tpu import api  # noqa: F401
from aehmc_tpu.api import sample  # noqa: F401  — the front door
from aehmc_tpu.types import (  # noqa: F401
    ChainState,
    Diagnostics,
    DualAveragingState,
    IntegratorState,
    ProposalState,
    TerminationState,
    WelfordState,
)
