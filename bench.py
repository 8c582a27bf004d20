"""Headline benchmark: the flagship on the front door's default route.

``aehmc_tpu.sample`` NUTS through ``auto`` -> ``pooled`` (XLA kernels,
pooled Stan window adaptation) on 10,240 chains x the 100-d, 1,000-row
logistic regression, under the flagship protocol: 150 warmup steps plus
200 draws.  Compile is timed apart (the cold call); walls are medians of
warm calls, and since one program runs warmup and sampling, the sampling
wall is the difference to a run with twice the draws.  The headline
value is sampling-phase leapfrog gradient-evals/s; the record also
carries sampling and end-to-end ESS/s (= sampling ESS / total wall).
``vs_baseline`` divides by the reference's only recorded anchor —
15.9k grad-evals/s on one CPU core (BASELINE.md row 1, ref
examples/LinearRegression.ipynb cell 27).  That anchor config runs
afterwards as a secondary stderr record.

Every record names the device (``device_kind``, device count, and the
card's name and power limit from ``nvidia-smi``).  Without a GPU the
benchmark exits non-zero; a failed run is an error, never another
metric.  Prints exactly ONE JSON line on stdout; narration goes to
stderr.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_GRAD_EVALS_PER_SEC = 15_900.0  # BASELINE.md, notebook cell 27


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _git_commit():
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except Exception:
        return None


def _timed(fn, runs):
    """Median wall of `runs` post-compile executions of fn(run_idx)."""
    out = fn(0)  # compile + warm up
    jax.block_until_ready(out)
    times = []
    for r in range(runs):
        t0 = time.perf_counter()
        out = fn(1 + r)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def bench_flagship(num_chains=10_240, dim=100, W=150, D=200):
    """The front door's default route at the flagship width."""
    import aehmc_tpu
    from aehmc_tpu.models import logistic_regression
    from benchmarks.run import _ess_per_sec

    logprob_fn, q0 = logistic_regression(dim=dim, num_points=1000)
    keys = jax.random.split(jax.random.PRNGKey(0), num_chains)
    qs = jnp.tile(q0, (num_chains, 1)) + 0.1 * jax.vmap(
        lambda k: jax.random.normal(k, (dim,), jnp.float32)
    )(keys)

    def run(key, q, draws):
        return aehmc_tpu.sample(key, logprob_fn, q, draws, W,
                                max_num_expansions=6)

    # the front door traces and compiles its program on every call; under
    # one outer jit the warm calls time the run alone (the start is an
    # argument, not a constant XLA would fold into the program)
    jitted = jax.jit(run, static_argnums=2)
    t0 = time.perf_counter()
    jax.block_until_ready(jitted(jax.random.PRNGKey(10), qs, D))
    t_cold = time.perf_counter() - t0
    t_total, res = _timed(
        lambda r: jitted(jax.random.PRNGKey(10 + r), qs, D), 3
    )
    t_double, _ = _timed(
        lambda r: jitted(jax.random.PRNGKey(10 + r), qs, 2 * D), 3
    )
    t_samp = t_double - t_total
    t_warm = t_total - t_samp
    t0 = time.perf_counter()
    jax.block_until_ready(run(jax.random.PRNGKey(10), qs, D))
    t_call = time.perf_counter() - t0
    evals = int(np.sum(np.asarray(res.diagnostics.num_integration_steps)))
    accept = float(np.mean(np.asarray(res.diagnostics.acceptance_probability)))
    div = int(np.sum(np.asarray(res.diagnostics.is_diverging)))
    evals_per_sec = evals / t_samp
    ess_sec, min_ess, capped = _ess_per_sec(
        np.asarray(res.positions, np.float32), t_samp
    )
    e2e_ess_sec = ess_sec * t_samp / t_total
    log(
        f"flagship pooled NUTS: {num_chains} chains x {dim}-d logistic, "
        f"compile {t_cold - t_total:.2f}s, warmup {t_warm:.3f}s + sampling "
        f"{t_samp:.3f}s (a repeated front-door call {t_call:.3f}s); "
        f"{evals_per_sec / 1e6:.1f}M evals/s, "
        f"{e2e_ess_sec / 1e6:.2f}M ESS/s end-to-end; accept {accept:.3f}, "
        f"div {div}, min ESS {min_ess:.0f}"
    )
    return {
        "metric": "flagship_nuts_sampling_grad_evals_per_sec",
        "value": round(evals_per_sec, 1),
        "unit": "evals/s",
        "vs_baseline": round(evals_per_sec / BASELINE_GRAD_EVALS_PER_SEC, 2),
        "runs": 3,
        "stat": "median",
        "config": "aehmc_tpu.sample nuts auto->pooled, max depth 6",
        "chains": num_chains,
        "dim": dim,
        "warmup_steps": W,
        "draws": D,
        "compile_s": round(t_cold - t_total, 3),
        "warmup_wall_s": round(t_warm, 4),
        "sampling_wall_s": round(t_samp, 4),
        "front_door_call_s": round(t_call, 4),
        "sampling_ess_per_sec": round(ess_sec),
        "end_to_end_ess_per_sec": round(e2e_ess_sec),
        "min_ess": round(min_ess),
        "ess_capped": capped,
        "accept": round(accept, 3),
        "divergences": div,
    }


def bench_hmc_linear_regression(num_chains=1024, num_draws=100, L=1024):
    """SECONDARY record: the reference's only recorded benchmark — the
    LinearRegression.ipynb HMC config (10k points, 2 params, 1,024
    leapfrog steps per draw; BASELINE.md row 1: 15.9k grad-evals/s on
    one CPU core) — chain-batched on one GPU via the XLA path."""
    from aehmc_tpu import hmc
    from aehmc_tpu.models import linear_regression
    from aehmc_tpu.sampling import sample_loop

    logprob_fn, q0 = linear_regression(num_points=10_000)
    q0 = q0.astype(jnp.float32)
    kernel = hmc.new_kernel(logprob_fn)
    step_size = jnp.asarray(5e-3, jnp.float32)
    imm = jnp.asarray([1e-2, 1e-4], jnp.float32)

    def run(key, positions):
        states = jax.vmap(lambda q: hmc.new_state(q, logprob_fn))(positions)
        keys = jax.random.split(key, num_chains)

        def chain(k, s):
            bound = lambda kk, ss: kernel(kk, ss, step_size, imm, L)  # noqa: E731
            final, _, infos = sample_loop(k, bound, s, num_draws)
            return final.position, infos.acceptance_probability

        return jax.vmap(chain)(keys, states)

    positions = jnp.tile(q0, (num_chains, 1)) + 0.01 * jax.random.normal(
        jax.random.PRNGKey(1), (num_chains, 2), jnp.float32
    )
    jitted = jax.jit(run)
    elapsed, out = _timed(
        lambda r: jitted(jax.random.PRNGKey(1 + r), positions), 5
    )
    grad_evals = num_chains * num_draws * L
    evals_per_sec = grad_evals / elapsed
    accept = float(jnp.mean(out[1]))
    log(
        f"[anchor] HMC linreg: {num_chains} chains x {num_draws} draws x "
        f"{L} leapfrog = {grad_evals:,} grad evals in {elapsed:.2f}s "
        f"-> {evals_per_sec:,.0f} evals/s "
        f"({evals_per_sec / BASELINE_GRAD_EVALS_PER_SEC:,.0f}x "
        f"the reference CPU anchor; mean accept {accept:.3f})"
    )
    return evals_per_sec


def main():
    import chip_smoke
    from aehmc_tpu.utils import enable_compilation_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        log(f"no GPU: JAX found {devices[0].platform!r} devices")
        sys.exit(1)
    cache_dir = enable_compilation_cache()
    card = chip_smoke.card_info().splitlines()[0]
    log(f"devices: {len(devices)} x {devices[0].device_kind} ({card}), "
        f"compile cache: {cache_dir}")
    result = bench_flagship()
    bench_hmc_linear_regression()
    result.update(
        device_kind=devices[0].device_kind,
        device_count=len(devices),
        card=card,
    )
    commit = _git_commit()
    if commit:
        result["commit"] = commit
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
