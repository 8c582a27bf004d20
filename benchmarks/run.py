"""The BASELINE.md benchmark configs plus the sampler/kernel variants.

Run:  python benchmarks/run.py [config ...]
Configs: readme_nuts, linreg_warmup, mvn25_dense, funnel, logistic_10k,
chees_10k, meads_10k, meads_10k_amortized, mala_10k, gpu_gates,
lint_gates, all.

Each prints one JSON line per config (stdout); narration on stderr.
``bench.py`` at the repo root remains the driver's single headline metric.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


_RUN_ID = None


def _run_id():
    """Commit hash (cached per process) so append-only result logs can
    evidence which tree each record validated."""
    global _RUN_ID
    if _RUN_ID is None:
        try:
            commit = __import__("subprocess").run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=10,
            ).stdout.strip() or "unknown"
        except Exception:
            commit = "unknown"
        dirty = ""
        try:
            st = __import__("subprocess").run(
                ["git", "status", "--porcelain"],
                capture_output=True, text=True, timeout=10,
            ).stdout.strip()
            if st:
                dirty = "-dirty"
        except Exception:
            pass
        _RUN_ID = commit + dirty
    return _RUN_ID


def _emit(name, value, unit, extra=None):
    rec = {"config": name, "value": round(float(value), 2), "unit": unit}
    if extra:
        rec.update(extra)
    rec.setdefault("device_kind", jax.devices()[0].device_kind)
    rec.setdefault("device_count", len(jax.devices()))
    rec.setdefault("commit", _run_id())
    rec.setdefault("ts", time.strftime("%Y-%m-%dT%H:%M:%S"))
    line = json.dumps(rec)
    print(line, flush=True)
    # stdout disappears into pipes/timeouts too easily; mirror every
    # record to a durable log when AEHMC_RESULTS_FILE is set
    results_file = __import__("os").environ.get("AEHMC_RESULTS_FILE")
    if results_file:
        with open(results_file, "a") as fh:
            fh.write(line + "\n")


MIN_DRAWS_PER_CHAIN = 200
TIMED_RUNS = 5


def _ess_per_sec(positions, elapsed):
    """positions: (draws, chains, dim) or (draws, chains).

    Hardened protocol: rank-normalized bulk ESS and tail ESS per
    dimension; reported ESS is sum over dims of min(bulk, tail), capped at
    the total draw count chains*draws with a ``capped`` flag when any raw
    estimate exceeded it (antithetic trajectories inflate bulk ESS on short
    chains). Requires >= 200 draws/chain for a stable Geyer estimate.
    """
    from aehmc_tpu.diagnostics import (
        effective_sample_size,
        tail_effective_sample_size,
    )

    samples = np.swapaxes(np.asarray(positions), 0, 1)  # (chains, draws, ...)
    chains, draws = samples.shape[0], samples.shape[1]
    if draws < MIN_DRAWS_PER_CHAIN:
        raise ValueError(
            f"ESS protocol requires >= {MIN_DRAWS_PER_CHAIN} draws/chain, "
            f"got {draws}"
        )
    # ESS is per-dimension independent: chunk the dim axis so the on-device
    # rank-normalize/FFT never runs out of device memory on multi-GB draw
    # arrays.
    squeeze = samples.ndim == 2
    if squeeze:
        samples = samples[:, :, None]
    num_dims = samples.shape[2]
    chunk = max(1, min(num_dims, int(2e8 / (chains * draws * 4))))
    bulk_parts, tail_parts = [], []
    ess_bulk = jax.jit(effective_sample_size)
    ess_tail = jax.jit(tail_effective_sample_size)
    for lo in range(0, num_dims, chunk):
        part = jnp.asarray(samples[:, :, lo : lo + chunk])
        bulk_parts.append(np.asarray(ess_bulk(part)))
        tail_parts.append(np.asarray(ess_tail(part)))
    bulk = np.concatenate(bulk_parts)
    tail = np.concatenate(tail_parts)
    if squeeze:
        bulk, tail = bulk[0], tail[0]
    ess = np.minimum(bulk, tail)
    n_total = chains * draws
    capped = bool(np.any(ess > n_total))
    ess = np.minimum(ess, n_total)
    return float(np.sum(ess) / elapsed), float(np.min(ess)), capped


def _median_time(fn, runs=TIMED_RUNS):
    """Median wall time of ``runs`` post-warmup executions of ``fn(run_idx)``.

    Returns (median_seconds, last_output). fn must block on its own output.
    """
    times = []
    out = None
    for r in range(runs):
        t0 = time.perf_counter()
        out = fn(r)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def readme_nuts():
    """Config 1: single-chain NUTS on a 1-D standard normal, 100 steps
    (the reference README example, ref README.md:41-53)."""
    from aehmc_tpu import nuts
    from aehmc_tpu.models import std_normal
    from aehmc_tpu.sampling import sample_loop

    logprob_fn = std_normal()
    kernel = nuts.new_kernel(logprob_fn)
    state = nuts.new_state(jnp.asarray(1.0, jnp.float32), logprob_fn)
    bound = lambda k, s: kernel(  # noqa: E731
        k, s, jnp.asarray(0.9, jnp.float32), jnp.asarray(1.0, jnp.float32)
    )
    run = jax.jit(lambda key: sample_loop(key, bound, state, 100))
    out = run(jax.random.PRNGKey(0))
    jax.block_until_ready(out)
    dt, _ = _median_time(lambda r: run(jax.random.PRNGKey(1 + r)))
    _emit(
        "readme_nuts_100_steps",
        dt * 1e3,
        "ms",
        {"draws_per_sec": round(100 / dt), "runs": TIMED_RUNS, "stat": "median"},
    )


def linreg_warmup():
    """Config 2: LinearRegression posterior with full window adaptation."""
    from aehmc_tpu import nuts, window_adaptation
    from aehmc_tpu.models import linear_regression

    logprob_fn, q0 = linear_regression(num_points=10_000)
    q0 = q0.astype(jnp.float32)
    kernel = nuts.new_kernel(logprob_fn)
    state = nuts.new_state(q0, logprob_fn)

    run = jax.jit(
        lambda key: window_adaptation.run(
            key, kernel, state, num_steps=1000, initial_step_size=0.1
        )
    )
    out = run(jax.random.PRNGKey(0))
    jax.block_until_ready(out)
    dt, (_, (eps, imm), info) = _median_time(
        lambda r: run(jax.random.PRNGKey(1 + r))
    )
    evals = int(np.sum(np.asarray(info.num_integration_steps)))
    log(f"linreg warmup: eps={float(eps):.4f} imm={np.asarray(imm)} evals={evals}")
    _emit(
        "linreg_window_adaptation_1000",
        dt,
        "s",
        {
            "grad_evals_per_sec": round(evals / dt),
            "runs": TIMED_RUNS,
            "stat": "median",
        },
    )


def mvn25_dense():
    """Config 3: 25-d correlated MVN, dense mass matrix NUTS."""
    from aehmc_tpu import nuts
    from aehmc_tpu.models import correlated_mvn
    from aehmc_tpu.sampling import sample_loop

    dim, rho = 25, 0.5
    logprob_fn = correlated_mvn(dim, rho)
    cov = np.full((dim, dim), rho, dtype=np.float32)
    np.fill_diagonal(cov, 1.0)

    kernel = nuts.new_kernel(logprob_fn)
    num_chains, num_draws = 512, 200
    imm = jnp.asarray(cov)  # true covariance as dense inverse mass matrix
    eps = jnp.asarray(0.8, jnp.float32)

    def run(key):
        keys = jax.random.split(key, num_chains)
        qs = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float32))(keys)
        states = jax.vmap(lambda q: nuts.new_state(q, logprob_fn))(qs)

        def chain(k, s):
            bound = lambda kk, ss: kernel(kk, ss, eps, imm)  # noqa: E731
            _, pos, infos = sample_loop(k, bound, s, num_draws)
            return pos, infos.num_integration_steps

        return jax.vmap(chain)(keys, states)

    jitted = jax.jit(run)
    out = jitted(jax.random.PRNGKey(0))
    jax.block_until_ready(out)
    dt, (pos, steps) = _median_time(lambda r: jitted(jax.random.PRNGKey(1 + r)))
    ess_sec, min_ess, capped = _ess_per_sec(jnp.swapaxes(pos, 0, 1), dt)
    evals = int(np.sum(np.asarray(steps)))
    log(f"mvn25: {evals} evals, min ESS {min_ess:.0f}")
    _emit(
        "mvn25_dense_nuts",
        ess_sec,
        "ESS/s",
        {
            "grad_evals_per_sec": round(evals / dt),
            "chains": num_chains,
            "draws": num_draws,
            "min_ess": round(min_ess),
            "ess_capped": capped,
            "runs": TIMED_RUNS,
            "stat": "median",
        },
    )


def funnel():
    """Config 4: Neal's funnel, max tree depth 10 (stresses doubling)."""
    from aehmc_tpu import nuts
    from aehmc_tpu.models import neals_funnel
    from aehmc_tpu.sampling import sample_loop

    logprob_fn, q0 = neals_funnel(dim=10)
    q0 = q0.astype(jnp.float32)
    # deep trees: the paired subtree loop is ~1.9x here (PERF.md)
    kernel = nuts.new_kernel(
        logprob_fn, max_num_expansions=10, paired_leaves=True
    )
    num_chains, num_draws = 512, 200
    eps = jnp.asarray(0.2, jnp.float32)
    imm = jnp.ones(10, jnp.float32)

    def run(key):
        keys = jax.random.split(key, num_chains)
        qs = 0.1 * jax.vmap(lambda k: jax.random.normal(k, (10,), jnp.float32))(
            keys
        )
        states = jax.vmap(lambda q: nuts.new_state(q, logprob_fn))(qs)

        def chain(k, s):
            bound = lambda kk, ss: kernel(kk, ss, eps, imm)  # noqa: E731
            _, pos, infos = sample_loop(k, bound, s, num_draws)
            return pos, infos.num_integration_steps, infos.num_doublings

        return jax.vmap(chain)(keys, states)

    jitted = jax.jit(run)
    out = jitted(jax.random.PRNGKey(0))
    jax.block_until_ready(out)
    dt, (pos, steps, doublings) = _median_time(
        lambda r: jitted(jax.random.PRNGKey(1 + r))
    )
    evals = int(np.sum(np.asarray(steps)))
    ess_sec, min_ess, capped = _ess_per_sec(jnp.swapaxes(pos, 0, 1), dt)
    log(
        f"funnel: mean depth {float(np.mean(np.asarray(doublings))):.1f}, "
        f"max depth {int(np.max(np.asarray(doublings)))}, "
        f"min ESS {min_ess:.0f}"
    )
    _emit(
        "neals_funnel_depth10",
        evals / dt,
        "grad_evals/s",
        {
            "ess_per_sec": round(ess_sec),
            "min_ess": round(min_ess),
            "ess_capped": capped,
            "chains": num_chains,
            "runs": TIMED_RUNS,
            "stat": "median",
        },
    )


def logistic_10k():
    """Config 5: 10k chains, 100-d logistic regression.

    Uses pooled cross-chain warmup to tune (eps, M^-1): with a pooled-tuned
    step size all chains stop at the same tree depth (acceptance pinned at
    the 0.8 target), which eliminates the vmap straggler effect — untuned
    step sizes cost ~6x throughput in masked lanes waiting for the deepest
    chain.
    """
    from aehmc_tpu import hmc, nuts
    from aehmc_tpu.models import logistic_regression
    from aehmc_tpu.parallel.pooled import pooled_warmup
    from aehmc_tpu.sampling import sample_loop

    dim, num_chains, num_draws = 100, 10_240, 200
    logprob_fn, q0 = logistic_regression(dim=dim, num_points=1000)
    kernel = nuts.new_kernel(logprob_fn, max_num_expansions=8)

    keys = jax.random.split(jax.random.PRNGKey(0), num_chains)
    qs = jnp.tile(q0, (num_chains, 1)) + 0.1 * jax.vmap(
        lambda k: jax.random.normal(k, (dim,), jnp.float32)
    )(keys)
    states = jax.vmap(lambda q: hmc.new_state(q, logprob_fn))(qs)

    t0 = time.perf_counter()
    warm_states, (eps, imm), _ = jax.jit(
        lambda k: pooled_warmup(
            k, kernel, states, num_steps=150, initial_step_size=0.1
        )
    )(jax.random.PRNGKey(1))
    jax.block_until_ready(eps)
    warmup_wall = time.perf_counter() - t0
    log(
        f"logistic 10k pooled warmup (150 steps incl. compile): "
        f"{warmup_wall:.1f}s, eps={float(eps):.4f}"
    )

    def run(key):
        ks = jax.random.split(key, num_chains)

        def chain(k, s):
            bound = lambda kk, ss: kernel(kk, ss, eps, imm)  # noqa: E731
            _, pos, infos = sample_loop(k, bound, s, num_draws)
            return pos, infos.num_integration_steps

        return jax.vmap(chain)(ks, warm_states)

    jitted = jax.jit(run)
    out = jitted(jax.random.PRNGKey(2))
    jax.block_until_ready(out)
    dt, (pos, steps) = _median_time(lambda r: jitted(jax.random.PRNGKey(3 + r)))
    evals = int(np.sum(np.asarray(steps)))
    ess_sec, min_ess, capped = _ess_per_sec(jnp.swapaxes(pos, 0, 1), dt)
    log(f"logistic 10k chains: {evals:,} evals in {dt:.2f}s, min ESS {min_ess:.0f}")
    _emit(
        "logistic_10k_chains_100d",
        evals / dt,
        "grad_evals/s",
        {
            "ess_per_sec": round(ess_sec),
            "chains": num_chains,
            "draws": num_draws,
            "min_ess": round(min_ess),
            "ess_capped": capped,
            "warmup_wall_s": round(warmup_wall, 1),
            "runs": TIMED_RUNS,
            "stat": "median",
        },
    )


def chees_10k():
    """ChEES-HMC on the config-5 posterior: the regular alternative to
    NUTS — shared jittered trajectory lengths mean zero per-chain control
    flow and no straggler lanes."""
    from aehmc_tpu import chees, hmc
    from aehmc_tpu.models import logistic_regression

    dim, num_chains, num_draws = 100, 10_240, 200
    logprob_fn, q0 = logistic_regression(dim=dim, num_points=1000)
    keys = jax.random.split(jax.random.PRNGKey(0), num_chains)
    qs = jnp.tile(q0, (num_chains, 1)) + 0.1 * jax.vmap(
        lambda k: jax.random.normal(k, (dim,), jnp.float32)
    )(keys)
    states = jax.vmap(lambda q: hmc.new_state(q, logprob_fn))(qs)

    t0 = time.perf_counter()
    result = jax.jit(
        lambda k: chees.warmup(
            k, logprob_fn, states, num_steps=300, initial_step_size=0.05
        )
    )(jax.random.PRNGKey(1))
    jax.block_until_ready(result.step_size)
    warmup_wall = time.perf_counter() - t0

    sampler = jax.jit(
        lambda k: chees.sample(
            k,
            logprob_fn,
            result.states,
            num_draws,
            result.step_size,
            result.trajectory_length,
            result.inverse_mass_matrix,
        )
    )
    out = sampler(jax.random.PRNGKey(2))
    jax.block_until_ready(out[1])
    dt, (_, pos, info) = _median_time(
        lambda r: sampler(jax.random.PRNGKey(3 + r))
    )
    accept = info.acceptance_probability
    evals = int(np.sum(np.asarray(info.num_integration_steps))) * num_chains
    ess_sec, min_ess, capped = _ess_per_sec(pos, dt)
    log(
        f"chees 10k: accept {float(np.mean(np.asarray(accept))):.3f}, "
        f"div {int(np.sum(np.asarray(info.is_diverging)))}, "
        f"min ESS {min_ess:.0f}, warmup {warmup_wall:.1f}s"
    )
    _emit(
        "chees_10k_chains_100d",
        evals / dt,
        "grad_evals/s",
        {
            "ess_per_sec": round(ess_sec),
            "chains": num_chains,
            "draws": num_draws,
            "min_ess": round(min_ess),
            "ess_capped": capped,
            "warmup_wall_s": round(warmup_wall, 1),
            "runs": TIMED_RUNS,
            "stat": "median",
        },
    )


def _meads_10k_impl(name, recompute_every):
    from aehmc_tpu import meads
    from aehmc_tpu.models import logistic_regression

    dim, num_chains, num_draws = 100, 10_240, 500
    logprob_fn, q0 = logistic_regression(dim=dim, num_points=1000)
    keys = jax.random.split(jax.random.PRNGKey(0), num_chains)
    qs = jnp.tile(q0, (num_chains, 1)) + 0.1 * jax.vmap(
        lambda k: jax.random.normal(k, (dim,), jnp.float32)
    )(keys)

    t0 = time.perf_counter()
    warm = jax.jit(
        lambda k: meads.sample(
            k, logprob_fn, qs, num_samples=1, num_warmup=500,
            recompute_every=recompute_every,
        )
    )(jax.random.PRNGKey(1))
    jax.block_until_ready(warm[0].position)
    warmup_wall = time.perf_counter() - t0
    states = warm[0]

    def draws_only(key, positions):
        _, pos, infos, _ = meads.sample(
            key, logprob_fn, positions, num_samples=num_draws,
            num_warmup=0, recompute_every=recompute_every,
        )
        return pos, infos.acceptance_probability

    sampler = jax.jit(lambda k: draws_only(k, states.position))
    out = sampler(jax.random.PRNGKey(2))
    jax.block_until_ready(out[0])
    dt, (pos, accept) = _median_time(
        lambda r: sampler(jax.random.PRNGKey(3 + r))
    )
    evals = num_draws * num_chains  # exactly one grad eval per transition
    ess_sec, min_ess, capped = _ess_per_sec(pos, dt)
    log(
        f"{name}: accept {float(np.mean(np.asarray(accept))):.3f}, "
        f"min ESS {min_ess:.0f}, warmup {warmup_wall:.1f}s"
    )
    _emit(
        name,
        evals / dt,
        "grad_evals/s",
        {
            "ess_per_sec": round(ess_sec),
            "chains": num_chains,
            "draws": num_draws,
            "min_ess": round(min_ess),
            "ess_capped": capped,
            "recompute_every": recompute_every,
            "warmup_wall_s": round(warmup_wall, 1),
            "runs": TIMED_RUNS,
            "stat": "median",
        },
    )


def meads_10k():
    """MEADS on the config-5 posterior: tuning-free adaptive GHMC — one
    leapfrog per transition, zero per-chain control flow, hyperparameters
    re-estimated cross-fold every iteration (see aehmc_tpu/meads.py)."""
    _meads_10k_impl("meads_10k_chains_100d", 1)


def meads_10k_amortized():
    """MEADS with hyperparameter re-estimation every 8 iterations — the
    amortized kernel (aehmc_tpu/meads.py new_kernel recompute_every)."""
    _meads_10k_impl("meads_10k_chains_100d_amortized", 8)


def mala_10k():
    """MALA on the flagship posterior through the XLA path: pooled
    warmup (Stan windows over the MALA kernel) + vmapped scan sampling;
    per-phase walls, compile excluded, median-of-5 sampling."""
    from aehmc_tpu import hmc, mala
    from aehmc_tpu.parallel.pooled import pooled_warmup
    from aehmc_tpu.sampling import sample_loop

    from aehmc_tpu.models import logistic_regression

    dim, num_chains = 100, 10_240
    logprob_fn, q0 = logistic_regression(dim=dim, num_points=1000)
    keys = jax.random.split(jax.random.PRNGKey(0), num_chains)
    qs = jnp.tile(q0, (num_chains, 1)) + 0.1 * jax.vmap(
        lambda k: jax.random.normal(k, (dim,), jnp.float32)
    )(keys)
    num_draws, W = 600, 150
    kernel = mala.new_kernel(logprob_fn)
    states = jax.vmap(lambda q: hmc.new_state(q, logprob_fn))(qs)

    warm = jax.jit(
        lambda k: pooled_warmup(
            k, kernel, states, num_steps=W, initial_step_size=0.1
        )
    )
    out = warm(jax.random.PRNGKey(1))
    jax.block_until_ready(out)
    t_warm, (warm_states, (eps, imm), _) = _median_time(
        lambda r: warm(jax.random.PRNGKey(1 + r)), runs=3
    )

    def run(key):
        ks = jax.random.split(key, num_chains)

        def chain(k, s):
            bound = lambda kk, ss: kernel(kk, ss, eps, imm)  # noqa: E731
            _, pos, infos = sample_loop(k, bound, s, num_draws)
            return pos, infos.acceptance_probability

        return jax.vmap(chain)(ks, warm_states)

    jitted = jax.jit(run)
    out = jitted(jax.random.PRNGKey(2))
    jax.block_until_ready(out)
    dt, (pos, accept) = _median_time(lambda r: jitted(jax.random.PRNGKey(3 + r)))
    evals = num_chains * num_draws  # one gradient per MALA draw
    ess_sec, min_ess, capped = _ess_per_sec(jnp.swapaxes(pos, 0, 1), dt)
    log(
        f"mala 10k XLA: {evals:,} evals in {dt:.2f}s "
        f"({evals / dt / 1e6:.1f}M evals/s), eps {float(eps):.4f}, "
        f"accept {float(jnp.mean(accept)):.3f}, min ESS {min_ess:.0f}"
    )
    _emit(
        "mala_10k_chains_100d",
        evals / dt,
        "grad_evals/s",
        {
            "chains": num_chains, "dim": dim, "draws": num_draws,
            "warmup_steps": W, "warmup_wall_s": round(t_warm, 3),
            "sampling_wall_s": round(dt, 3),
            "ess_per_sec": round(ess_sec), "min_ess": round(min_ess),
            "ess_capped": capped,
            "accept": round(float(jnp.mean(accept)), 3),
            "runs": TIMED_RUNS, "stat": "median",
        },
    )


def gpu_gates():
    """The GPU-marked statistical gates (tests/test_gpu_gates.py), run in
    this process: a second JAX process would find the card's memory
    already reserved.  Emits one pass/fail record."""
    import os
    import pathlib

    import pytest

    root = pathlib.Path(__file__).resolve().parent.parent
    os.environ["AEHMC_DEVICE_SUITE"] = "1"  # keep tests/conftest.py off CPU
    code = int(pytest.main([
        "-q", "-p", "no:cacheprovider", "-m", "gpu",
        str(root / "tests" / "test_gpu_gates.py"),
    ]))
    _emit("gpu_statistical_gates", 1.0 if code == 0 else 0.0, "pass",
          {"suite": "tests/test_gpu_gates.py", "pytest_exit": code})


def lint_gates():
    """Executable lint gate (CI declares ruff + mypy, but neither is
    installed here and there is no network).  Runs the in-repo AST
    linter (tools/lint.py: E999/F401/F811/F632/W605/E501 approximations)
    plus a full ``compileall`` syntax pass and records pass/fail.  The
    ruff/mypy CI jobs remain the richer gates where a network exists."""
    import compileall
    import pathlib

    from tools.lint import run as lint_run

    root = pathlib.Path(__file__).resolve().parent.parent
    files, problems = lint_run(root)
    ok_compile = all(
        compileall.compile_dir(
            str(root / d), quiet=2, force=True
        )
        for d in ("aehmc_tpu", "tests", "benchmarks", "tools")
    )
    for path, lineno, code, msg in problems:
        log(f"lint: {path}:{lineno}: {code} {msg}")
    _emit(
        "lint_gates",
        0 if (problems or not ok_compile) else 1,
        "pass",
        {
            "files_checked": len(files),
            "problems": len(problems),
            "compileall_ok": bool(ok_compile),
            "note": "tools/lint.py AST checks + compileall; ruff/mypy "
                    "unavailable offline (CI declares them)",
        },
    )


CONFIGS = {
    "readme_nuts": readme_nuts,
    "linreg_warmup": linreg_warmup,
    "mvn25_dense": mvn25_dense,
    "funnel": funnel,
    "logistic_10k": logistic_10k,
    "chees_10k": chees_10k,
    "meads_10k": meads_10k,
    "meads_10k_amortized": meads_10k_amortized,
    "mala_10k": mala_10k,
    "gpu_gates": gpu_gates,
    "lint_gates": lint_gates,
}


def main():
    from aehmc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    names = sys.argv[1:] or ["all"]
    if names == ["all"]:
        names = list(CONFIGS)
    device = jax.devices()[0]
    if device.platform != "gpu" and names != ["lint_gates"]:
        log(f"no GPU: JAX found {device.platform!r} devices")
        sys.exit(1)
    log(f"devices: {len(jax.devices())} x {device.device_kind}")
    for name in names:
        CONFIGS[name]()


if __name__ == "__main__":
    main()
