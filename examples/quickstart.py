"""Quickstart: the front-door API in 20 lines.

``aehmc_tpu.sample`` is the one entry point: give it a log-density and
an initial position and it warms up (Stan window adaptation) and
samples.  A 1-D position runs one chain; a (chains, dim) batch runs
pooled cross-chain adaptation sharded over every attached device.

Run:  python examples/quickstart.py
"""

import sys

sys.path.insert(
    0, str(__import__("pathlib").Path(__file__).resolve().parent.parent)
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import aehmc_tpu  # noqa: E402

# ---- the 20-line quickstart (docs/api.md) ------------------------------


def logprob_fn(q):  # any JAX-traceable log density
    return -0.5 * jnp.sum(q * q)


key = jax.random.PRNGKey(0)

# one chain, NUTS, tuned step size + mass matrix:
out = aehmc_tpu.sample(key, logprob_fn, jnp.zeros(4),
                       num_samples=500, num_warmup=500)
print("single chain:", out.positions.shape, "eps", float(out.step_size))

# a fleet of chains, pooled warmup, sharded over every device:
q0 = jax.random.normal(key, (256, 4), jnp.float32)
out = aehmc_tpu.sample(key, logprob_fn, q0, 500, 500)
print("pooled fleet:", out.positions.shape)

# same fleet through a different algorithm (ChEES-HMC — no tree, regular):
out = aehmc_tpu.sample(key, logprob_fn, q0, 500, 500, algorithm="chees")
print("chees fleet :", out.positions.shape)
