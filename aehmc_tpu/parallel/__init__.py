"""Multi-device execution over a device mesh.

The reference is strictly single-process, single-chain (SURVEY.md §2); this
package is the scaling layer: chains shard over a ``jax.sharding.Mesh``
axis, per-chain sampling needs zero communication, and the only collectives
are the cross-chain reductions of pooled adaptation and convergence
diagnostics — which XLA issues across devices automatically when the
reduced axis is sharded.
"""

from aehmc_tpu.parallel.mesh import (  # noqa: F401
    chain_sharding,
    make_mesh,
    make_multislice_mesh,
)
from aehmc_tpu.parallel.pooled import (  # noqa: F401
    pooled_warmup,
    sample_sharded,
)
