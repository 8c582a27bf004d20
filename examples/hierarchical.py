"""Hierarchical posteriors at fleet scale: Neal's funnel and the eight
schools through pooled NUTS on the front door's default route.

Run:  python examples/hierarchical.py  (on the GPU; on the CPU it runs a
small fleet).
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(
    0, str(__import__("pathlib").Path(__file__).resolve().parent.parent)
)

from aehmc_tpu.diagnostics import summary  # noqa: E402
from aehmc_tpu.models import eight_schools, neals_funnel  # noqa: E402
from aehmc_tpu.utils import enable_compilation_cache  # noqa: E402

import aehmc_tpu  # noqa: E402


def run(name, logprob_fn, dim, *, chains, target=0.85):
    q0 = 0.1 * jax.random.normal(
        jax.random.PRNGKey(0), (chains, dim), jnp.float32
    )

    def call(key):
        return aehmc_tpu.sample(
            key, logprob_fn, q0, num_samples=500, num_warmup=500,
            max_num_expansions=10, target_acceptance_rate=target,
        )

    jax.block_until_ready(call(jax.random.PRNGKey(1)).positions)  # compile
    t0 = time.time()
    res = call(jax.random.PRNGKey(2))
    jax.block_until_ready(res.positions)
    wall = time.time() - t0
    accept = float(jnp.mean(res.diagnostics.acceptance_probability))
    div_frac = float(jnp.mean(res.diagnostics.is_diverging))
    s = summary(jnp.swapaxes(res.positions, 0, 1)[:, 100:])
    print(
        f"{name}: {wall:.2f} s for 1000 steps x {chains} chains "
        f"(tuned eps {float(jnp.mean(res.step_size)):.3f}); accept "
        f"{accept:.2f}, divergent fraction {div_frac:.4f}, max r_hat "
        f"{float(jnp.max(s['r_hat'])):.3f}"
    )
    return res.positions


def main():
    enable_compilation_cache()
    chains = 2048 if jax.default_backend() == "gpu" else 64

    funnel, _ = neals_funnel(dim=10)
    pos = run("Neal's funnel (dim 10)", funnel, 10, chains=chains,
              target=0.9)
    v = np.asarray(pos)[100:, :, 0].ravel()
    print(f"  funnel v: mean {v.mean():.2f}, sd {v.std():.2f} (target 0, 3)")

    schools, _ = eight_schools(non_centered=True)
    pos = run("eight schools (non-centered)", schools, 10, chains=chains)
    draws = np.asarray(pos)[100:]
    mu = draws[:, :, 0].ravel()
    tau = np.exp(draws[:, :, 1].ravel())
    print(
        f"  mu: {mu.mean():.1f} +- {mu.std():.1f}; tau median "
        f"{np.median(tau):.1f}"
    )


if __name__ == "__main__":
    main()
