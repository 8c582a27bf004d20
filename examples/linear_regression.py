"""Linear regression end-to-end example.

Mirrors the reference's ``examples/LinearRegression.ipynb`` (10k data points,
normal prior on the weight, Gamma noise scale sampled in log space): build the
log-density, map named parameters to a flat vector with RaveledParamsMap, run
HMC and NUTS with full window adaptation, and report timings and posterior
summaries — all on whatever backend JAX picks (the GPU when available).

Run: python examples/linear_regression.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from aehmc_tpu.diagnostics import effective_sample_size
from aehmc_tpu.sampling import sample
from aehmc_tpu.utils import RaveledParamsMap


def make_model(num_points=10_000, seed=8927):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.normal(0.0, 1.0, size=num_points), jnp.float32)
    true_w, true_sigma = 3.0, 1.0
    y = jnp.asarray(
        true_w * np.asarray(X) + rng.normal(0.0, true_sigma, size=num_points),
        jnp.float32,
    )

    params = {"w": np.zeros(()), "log_sigma": np.zeros(())}
    rp_map = RaveledParamsMap(params, dtype=jnp.float32)

    def logprob_fn(q):
        p = rp_map.unravel_params(q)
        w, log_sigma = p["w"], p["log_sigma"]
        sigma = jnp.exp(log_sigma)
        lp = -0.5 * (w / 10.0) ** 2                      # w ~ N(0, 10)
        lp += 2.0 * log_sigma - 2.0 * sigma              # sigma ~ Gamma(2,2), log-space
        resid = y - w * X
        lp += -num_points * log_sigma - 0.5 * jnp.sum(resid**2) / sigma**2
        return lp

    return logprob_fn, rp_map


def report(name, result, rp_map, elapsed):
    samples = np.asarray(result.positions)
    ess = np.asarray(effective_sample_size(jnp.asarray(samples)[None]))
    unraveled = rp_map.unravel_params(jnp.asarray(samples.mean(axis=0)))
    print(f"--- {name}: {elapsed:.2f}s for {samples.shape[0]} draws ---")
    print(f"  posterior mean w        = {float(unraveled['w']):.4f} (true 3.0)")
    print(
        "  posterior mean sigma    = "
        f"{float(np.exp(samples[:, 1]).mean()):.4f} (true 1.0)"
    )
    print(f"  min ESS                 = {ess.min():.0f}")
    print(f"  tuned step size         = {float(result.step_size):.5f}")


def main():
    from aehmc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    print(f"backend: {jax.default_backend()}")
    logprob_fn, rp_map = make_model()
    q0 = jnp.zeros(2, jnp.float32)

    t0 = time.time()
    result = sample(
        jax.random.PRNGKey(0), logprob_fn, q0,
        num_samples=1000, num_warmup=1000,
        algorithm="hmc", num_integration_steps=100,
        initial_step_size=0.01,
    )
    jax.block_until_ready(result.positions)
    report("HMC (1000 warmup + 1000 draws)", result, rp_map, time.time() - t0)

    t0 = time.time()
    result = sample(
        jax.random.PRNGKey(1), logprob_fn, q0,
        num_samples=1000, num_warmup=1000,
        initial_step_size=0.01,
    )
    jax.block_until_ready(result.positions)
    report("NUTS (1000 warmup + 1000 draws)", result, rp_map, time.time() - t0)


if __name__ == "__main__":
    main()
