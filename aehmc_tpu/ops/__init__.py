"""Reference implementations that check the samplers.

:mod:`aehmc_tpu.ops.nuts_oracle` is a NumPy NUTS transition with every
random input externalized: fed the same momentum, directions and uniforms,
it reproduces a transition decision for decision, in float64.
"""

from aehmc_tpu.ops.nuts_oracle import (  # noqa: F401
    nuts_transition_oracle,
    nuts_transition_oracle_generic,
)
