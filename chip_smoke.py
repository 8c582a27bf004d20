#!/usr/bin/env python3
"""Smoke test of aehmc_tpu on one NVIDIA GPU, through the user's entry points.

    python3 chip_smoke.py           # phases 0-3 on one card
    python3 chip_smoke.py --four    # the four-card mesh path only

Phases (any failure exits non-zero):

0. Device: the first JAX device must be a GPU; prints the card's name and
   power limit (``nvidia-smi``), the device count and the compile cache.
1. Main path: ``aehmc_tpu.sample`` NUTS on its default route (``auto`` ->
   ``pooled``) at the flagship width — 10,240 chains on the 100-d, 1,000-row
   logistic regression, 150 warmup + 200 draws.  Checks finite draws, mean
   acceptance within 0.05 of the target, no divergences and split-R-hat
   <= 1.05; prints compile time, warmup and sampling walls.
2. The other algorithms (hmc, chees, meads, ghmc, mala) through the pooled
   route at the same width, and the single-chain route.
3. The GPU-marked tests (``tests/test_gpu_gates.py``) in this process.

``--four`` runs the flagship on a 4-card mesh and on one card instead: the
pooled statistics of the same draws must agree to 1e-5, the tuned step size
and inverse mass matrix within the sampling error of the pooled draws they
come from, and the posterior means within 5 MCSE.

The last stdout line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = dict(num_chains=10_240, dim=100, num_points=1_000,
                num_warmup=150, num_samples=200)
TARGET_ACCEPT = 0.8
NUTS_MAX_DEPTH = 6


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


def card_info() -> str:
    """``name, power.limit`` of every card, from a child process that
    stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase_device():
    """Phase 0: a GPU or nothing."""
    import jax

    from aehmc_tpu.utils import enable_compilation_cache

    devices = jax.devices()
    check(devices[0].platform == "gpu",
          f"no GPU: JAX found {devices[0].platform!r} devices")
    cache = enable_compilation_cache()
    log(f"card: {card_info()}")
    log(f"devices: {len(devices)} x {devices[0].device_kind}; "
        f"compile cache: {cache}")
    return devices


def flagship_positions(num_chains, dim, seed=0):
    """The flagship protocol's start: the model's example point (zero)
    plus N(0, 0.1^2) jitter per chain."""
    import jax
    import jax.numpy as jnp

    z = jax.random.normal(jax.random.PRNGKey(seed), (num_chains, dim),
                          jnp.float32)
    return 0.1 * z


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def posterior_summary(positions):
    """Per-dimension means, MCSE and the largest split-R-hat of a
    (draws, chains, dim) draw array."""
    import jax.numpy as jnp

    from aehmc_tpu import diagnostics

    samples = jnp.swapaxes(jnp.asarray(positions, jnp.float32), 0, 1)
    mcse, _ = diagnostics.mcse(samples)
    rhat = diagnostics.potential_scale_reduction(samples)
    return (np.asarray(jnp.mean(samples, axis=(0, 1))), np.asarray(mcse),
            float(jnp.max(rhat)))


def check_sampling(res, name, *, target=TARGET_ACCEPT, max_rhat=1.05,
                   max_divergent=0):
    positions = np.asarray(res.positions)
    check(np.isfinite(positions).all(), f"{name}: non-finite draws")
    accept = float(np.mean(np.asarray(res.diagnostics.acceptance_probability)))
    divergent = int(np.sum(np.asarray(res.diagnostics.is_diverging)))
    means, mcse, rhat = posterior_summary(positions)
    log(f"  {name}: accept {accept:.4f} divergent {divergent} "
        f"max split-R-hat {rhat:.4f} eps {np.asarray(res.step_size).mean():.5g}")
    check(accept > 0.1, f"{name}: mean acceptance {accept:.3f}")
    if target is not None:
        check(abs(accept - target) <= 0.05,
              f"{name}: mean acceptance {accept:.3f} not within 0.05 of "
              f"{target}")
    check(divergent <= max_divergent,
          f"{name}: {divergent} divergent transitions")
    check(rhat <= max_rhat, f"{name}: split-R-hat {rhat:.4f} > {max_rhat}")
    return means, mcse


def phase_main(num_chains, dim, num_points, num_warmup, num_samples,
               card=""):
    """Phase 1: pooled NUTS through the front door at the given width."""
    import jax

    import aehmc_tpu
    from aehmc_tpu.models import logistic_regression

    logprob_fn, _ = logistic_regression(dim=dim, num_points=num_points)
    q0 = flagship_positions(num_chains, dim)
    key = jax.random.PRNGKey(1)

    def run(key, q, num_draws):
        return aehmc_tpu.sample(key, logprob_fn, q, num_draws, num_warmup,
                                max_num_expansions=NUTS_MAX_DEPTH)

    # aehmc_tpu.sample traces and compiles its program on every call; under
    # one outer jit the warm calls time the run alone.  The start is an
    # argument, not a constant XLA would fold into the program.  One program
    # runs warmup and sampling, so the sampling wall is the difference to a
    # run with twice the draws.
    jitted = jax.jit(run, static_argnums=2)
    _, t_cold = _timed(lambda: jitted(key, q0, num_samples))
    _, t_e2e = _timed(lambda: jitted(key, q0, num_samples))
    _timed(lambda: jitted(key, q0, 2 * num_samples))
    _, t_double = _timed(lambda: jitted(key, q0, 2 * num_samples))
    res, t_call = _timed(lambda: run(key, q0, num_samples))
    t_sampling = t_double - t_e2e
    log(f"  pooled NUTS {num_chains} chains x {dim}-d: compile "
        f"{t_cold - t_e2e:.2f} s, end-to-end {t_e2e:.3f} s (warmup "
        f"{t_e2e - t_sampling:.3f} s + sampling {t_sampling:.3f} s); a "
        f"repeated front-door call {t_call:.3f} s [{card}]")
    check_sampling(res, "pooled nuts")
    return res


def phase_algorithms(num_chains, dim, num_points, num_warmup, num_samples,
                     card=""):
    """Phase 2: the other algorithms through the pooled route, and the
    single-chain route."""
    import jax
    import jax.numpy as jnp

    import aehmc_tpu
    from aehmc_tpu.models import logistic_regression

    logprob_fn, example = logistic_regression(dim=dim, num_points=num_points)
    q0 = flagship_positions(num_chains, dim)
    for algorithm in ("hmc", "chees", "meads", "ghmc", "mala"):
        res, wall = _timed(lambda: aehmc_tpu.sample(
            jax.random.PRNGKey(2), logprob_fn, q0, num_samples, num_warmup,
            algorithm=algorithm,
        ))
        log(f"  {algorithm}: {wall:.2f} s including compile [{card}]")
        check(res.positions.shape == (num_samples, num_chains, dim),
              f"{algorithm}: positions shape {res.positions.shape}")
        # a short run: checked for sane output, not for convergence
        check_sampling(res, algorithm, target=None, max_rhat=np.inf,
                       max_divergent=num_chains // 100)
    res, wall = _timed(lambda: aehmc_tpu.sample(
        jax.random.PRNGKey(3), logprob_fn, jnp.asarray(example),
        num_samples, num_warmup,
    ))
    positions = np.asarray(res.positions)
    check(positions.shape == (num_samples, dim),
          f"single chain: positions shape {positions.shape}")
    check(np.isfinite(positions).all(), "single chain: non-finite draws")
    log(f"  single chain: {wall:.2f} s including compile, accept "
        f"{float(np.mean(res.diagnostics.acceptance_probability)):.3f}")


def phase_gpu_tests():
    """Phase 3: the GPU-marked tests, in this process (one process per
    card)."""
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["AEHMC_DEVICE_SUITE"] = "1"  # keep tests/conftest.py off CPU
    code = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                        os.path.join(here, "tests", "test_gpu_gates.py")])
    check(code == 0, f"GPU tests failed (pytest exit code {int(code)})")


def last_window_draws(num_chains, num_warmup):
    """Pooled draws behind the tuned mass matrix: chains x the length of
    the last slow window of Stan's warmup schedule."""
    from aehmc_tpu.window_adaptation import build_schedule

    schedule = build_schedule(num_warmup)
    ends = [-1] + [i for i, (_, end) in enumerate(schedule) if end]
    steps = sum(1 for i, (stage, _) in enumerate(schedule)
                if stage == 1 and i > ends[-2])
    return num_chains * steps


def phase_four(num_chains, dim, num_points, num_warmup, num_samples,
               card="", devices=None):
    """Pooled NUTS on a 4-card mesh vs one card.

    The pooled reductions sum in a fixed pairwise tree, so the pooled
    statistics of the same draws agree across the two meshes to 1e-5
    relative.  End to end, the per-chain f32 gradients are products of
    different shapes on the two meshes and may round differently, and
    NUTS amplifies any such difference over warmup; so the tuned step size
    and inverse mass matrix are held to the sampling error of the pooled
    statistics they come from, 5 sqrt(2/N) relative for the N pooled draws
    of the last slow window, and the posterior means to 5 MCSE.
    """
    import jax

    import aehmc_tpu
    from aehmc_tpu.algorithms import (pairwise_mean, welford_covariance,
                                      welford_update_batch)
    from aehmc_tpu.models import logistic_regression
    from aehmc_tpu.parallel.mesh import chain_sharding, make_mesh

    devices = jax.devices() if devices is None else devices
    check(len(devices) == 4, f"--four needs 4 devices, found {len(devices)}")
    logprob_fn, _ = logistic_regression(dim=dim, num_points=num_points)
    q0 = flagship_positions(num_chains, dim)
    meshes = {"one card": make_mesh(devices=devices[:1]),
              "four cards": make_mesh(devices=devices)}
    out = {}
    for name, mesh in meshes.items():
        res, t_cold = _timed(lambda: aehmc_tpu.sample(
            jax.random.PRNGKey(1), logprob_fn, q0, num_samples, num_warmup,
            mesh=mesh, max_num_expansions=NUTS_MAX_DEPTH,
        ))
        res, t_warm = _timed(lambda: aehmc_tpu.sample(
            jax.random.PRNGKey(1), logprob_fn, q0, num_samples, num_warmup,
            mesh=mesh, max_num_expansions=NUTS_MAX_DEPTH,
        ))
        log(f"  pooled NUTS on {name}: compile {t_cold - t_warm:.2f} s, "
            f"end-to-end {t_warm:.3f} s [{card}]")
        out[name] = (res, *check_sampling(res, name))
    (r1, m1, s1), (r4, m4, s4) = out["one card"], out["four cards"]

    # the same inputs on both meshes: pooled statistics, per-chain gradients
    init, _, final = welford_covariance(False)
    update = welford_update_batch(False)
    pooled = jax.jit(lambda x, a: (final(update(x, init(x.shape[1]))),
                                   pairwise_mean(a)))
    grad = jax.jit(jax.vmap(jax.grad(logprob_fn)))
    draws = np.asarray(r1.positions[-1])
    accept = np.asarray(r1.diagnostics.acceptance_probability[-1])
    same = {}
    for name, mesh in meshes.items():
        shard = chain_sharding(mesh)
        var, mean_accept = pooled(jax.device_put(draws, shard),
                                  jax.device_put(accept, shard))
        same[name] = (np.asarray(var), float(mean_accept),
                      np.asarray(grad(jax.device_put(draws, shard))))
    (v1, a1, g1), (v4, a4, g4) = same["one card"], same["four cards"]
    stats_rel = max(float(np.max(np.abs(v4 / v1 - 1.0))), abs(a4 / a1 - 1.0))
    grad_rel = float(np.max(np.abs(g4 - g1)) / np.max(np.abs(g1)))
    log(f"  same draws on 4 vs 1 card: pooled statistics rel {stats_rel:.2e}"
        f", per-chain gradients max rel {grad_rel:.2e} "
        f"({np.mean(g4 == g1):.4f} of entries bitwise equal)")
    check(stats_rel <= 1e-5,
          f"pooled statistics differ across meshes: {stats_rel:.2e} > 1e-5")

    eps_rel = abs(float(r4.step_size) / float(r1.step_size) - 1.0)
    imm_rel = float(np.max(np.abs(np.asarray(r4.inverse_mass_matrix)
                                  / np.asarray(r1.inverse_mass_matrix)
                                  - 1.0)))
    bound = 5.0 * np.sqrt(2.0 / last_window_draws(num_chains, num_warmup))
    z = float(np.max(np.abs(m4 - m1) / np.sqrt(s1**2 + s4**2)))
    log(f"  4 vs 1 card end to end: step size rel {eps_rel:.2e}, inverse "
        f"mass rel {imm_rel:.2e} (bound {bound:.2e}), means max "
        f"|diff|/MCSE {z:.2f}")
    check(eps_rel <= bound and imm_rel <= bound,
          f"tuned parameters differ across meshes beyond {bound:.2e}")
    check(z <= 5.0, f"posterior means differ by {z:.2f} MCSE")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card mesh path")
    args = parser.parse_args(argv)

    import jax

    try:
        log("phase 0: device")
        devices = phase_device()
        card = card_info().splitlines()[0]
        if args.four:
            log("four cards: pooled NUTS on a 4-card mesh vs one card")
            phase_four(**FLAGSHIP, card=card)
        else:
            log("phase 1: pooled NUTS through the front door")
            phase_main(**FLAGSHIP, card=card)
            log("phase 2: other algorithms, single-chain route")
            phase_algorithms(**{**FLAGSHIP, "num_warmup": 100,
                                "num_samples": 100}, card=card)
            log("phase 3: GPU-marked tests")
            phase_gpu_tests()
    except PhaseError as err:
        print(f"FAILED: {err}", file=sys.stderr, flush=True)
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
