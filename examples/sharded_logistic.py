"""Production-shaped example: many-chain Bayesian logistic regression on a GPU.

Covers the full round-trip a production user needs:

1. pooled cross-chain warmup + NUTS sampling sharded over the device mesh
   (``sample_sharded``), with periodic checkpointing so a preempted run
   resumes bit-for-bit;
2. posterior summary (arviz columns) and the arviz interop bridge.

Run:  python examples/sharded_logistic.py  (scales the chain count down
automatically when no GPU is attached).
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(
    0, str(__import__("pathlib").Path(__file__).resolve().parent.parent)
)

from aehmc_tpu.diagnostics import summary, to_inference_data_dict  # noqa: E402
from aehmc_tpu.models import logistic_regression_data  # noqa: E402
from aehmc_tpu.utils import enable_compilation_cache  # noqa: E402

import aehmc_tpu  # noqa: E402


def main():
    enable_compilation_cache()
    on_gpu = jax.default_backend() == "gpu"
    dim, num_points = 100, 1000
    num_chains = 2048 if on_gpu else 64
    num_draws, num_warmup = 300, 200

    X, y = logistic_regression_data(dim=dim, num_points=num_points)

    def logprob_fn(q):
        logits = X @ q
        loglik = jnp.sum(y * logits - jnp.logaddexp(0.0, logits))
        return loglik - 0.5 * jnp.sum(q**2)

    q0 = 0.1 * jax.random.normal(
        jax.random.PRNGKey(0), (num_chains, dim), jnp.float32
    )

    # --- 1. sharded sampling with checkpointing -------------------------
    # the front door: a (chains, dim) batch routes to pooled cross-chain
    # adaptation sharded over every attached device
    t0 = time.time()
    res = aehmc_tpu.sample(
        jax.random.PRNGKey(1),
        logprob_fn,
        q0,
        num_samples=num_draws,
        num_warmup=num_warmup,
        checkpoint_every=100,
        checkpoint_path="/tmp/logistic_run.npz",  # resume=True to restart
    )
    print(
        f"sampled {num_draws} draws x {num_chains} chains in "
        f"{time.time() - t0:.1f}s (eps={float(res.step_size):.4f}, "
        f"divergences={int(np.sum(np.asarray(res.diagnostics.is_diverging)))})"
    )

    # --- 2. summary + arviz bridge --------------------------------------
    chains_first = jnp.swapaxes(res.positions, 0, 1)  # (chains, draws, dim)
    s = jax.jit(summary)(chains_first)
    print(
        f"posterior: max |mean| {float(jnp.max(jnp.abs(s['mean']))):.3f}, "
        f"max r_hat {float(jnp.max(s['r_hat'])):.4f}, "
        f"min bulk ESS {float(jnp.min(s['ess_bulk'])):.0f}"
    )
    idata_dict = to_inference_data_dict(res.positions, res.diagnostics)
    print(f"arviz bridge: {len(idata_dict['posterior'])} posterior vars, "
          f"stats {sorted(idata_dict['sample_stats'])}")


if __name__ == "__main__":
    main()
