"""Checkpoint/resume: a resumed run must continue bit-for-bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aehmc_tpu import checkpoint, nuts
from aehmc_tpu.models import std_normal


def test_npz_roundtrip_pytree(tmp_path):
    state = {
        "position": jnp.arange(4.0),
        "nested": (jnp.ones((2, 2)), jnp.asarray(3, jnp.int32)),
        "key": jax.random.PRNGKey(0),
    }
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, state)
    restored = checkpoint.restore(path, state)
    for a, b in zip(
        jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(restored)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert a.dtype == b.dtype


def test_resume_continues_bitwise(tmp_path):
    """Run 100 steps; or run 50, checkpoint, restore, run 50 more — the
    final draws must be identical bits."""
    logprob_fn = std_normal()
    kernel = nuts.new_kernel(logprob_fn)
    bound = lambda key, s: kernel(  # noqa: E731
        key, s, jnp.asarray(0.5), jnp.ones(2)
    )
    initial = nuts.new_state(jnp.zeros(2), logprob_fn)

    # A sample loop that carries its own key so it can be checkpointed.
    def run(key, state, n):
        keys = jax.random.split(key, n)

        def one(s, k):
            s, info = bound(k, s)
            return s, s.position

        return jax.lax.scan(one, state, keys)

    master = jax.random.PRNGKey(123)
    k1, k2 = jax.random.split(master)

    # uninterrupted: 50 with k1 then 50 with k2
    state_mid, pos_a = run(k1, initial, 50)
    state_end, pos_b = run(k2, state_mid, 50)
    full = np.concatenate([np.asarray(pos_a), np.asarray(pos_b)])

    # interrupted at step 50
    state_mid2, pos_a2 = run(k1, initial, 50)
    path = str(tmp_path / "resume.npz")
    checkpoint.save(path, {"state": state_mid2, "key": k2})
    restored = checkpoint.restore(path, {"state": state_mid2, "key": k2})
    _, pos_b2 = run(restored["key"], restored["state"], 50)
    resumed = np.concatenate([np.asarray(pos_a2), np.asarray(pos_b2)])

    np.testing.assert_array_equal(full, resumed)


@pytest.mark.parametrize(
    "algorithm", ["nuts", "hmc", "mala", "ghmc", "chees", "meads"]
)
def test_sample_sharded_warmup_checkpoint_resume(tmp_path, algorithm):
    """A run killed MID-WARMUP resumes from the last warmup snapshot
    (no restart) and reproduces the uninterrupted checkpointed run bit
    for bit — the warmup carry (chain states, adaptation state, PRNG
    key) is a pure pytree segmented exactly like sampling."""
    import os

    from aehmc_tpu.parallel import sample_sharded

    logprob_fn = std_normal()
    key = jax.random.PRNGKey(9)
    qs = jax.random.normal(jax.random.PRNGKey(10), (8, 2))
    common = dict(
        num_samples=20,
        num_warmup=35,
        algorithm=algorithm,
        checkpoint_every=10,
    )

    full = sample_sharded(
        key, logprob_fn, qs,
        checkpoint_path=str(tmp_path / "full.npz"), **common,
    )

    path = str(tmp_path / "run.npz")
    crashed = sample_sharded(
        key, logprob_fn, qs,
        checkpoint_path=path, _crash_after_warmup_segments=2, **common,
    )
    assert crashed is None  # killed during warmup
    warmup_path = path[: -len(".npz")] + "_warmup.npz"
    assert os.path.exists(warmup_path)
    assert not os.path.exists(path)
    resumed = sample_sharded(
        key, logprob_fn, qs, checkpoint_path=path, resume=True, **common,
    )

    np.testing.assert_array_equal(
        np.asarray(full.positions), np.asarray(resumed.positions)
    )
    assert float(full.step_size) == float(resumed.step_size)
    np.testing.assert_array_equal(
        np.asarray(full.inverse_mass_matrix),
        np.asarray(resumed.inverse_mass_matrix),
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(full.final_state),
        jax.tree_util.tree_leaves(resumed.final_state),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize(
    "algorithm", ["nuts", "hmc", "mala", "ghmc", "chees", "meads"]
)
def test_sample_sharded_checkpoint_resume(tmp_path, algorithm):
    """Driver-integrated checkpointing: a run killed mid-sampling and
    resumed reproduces the uninterrupted run bit-for-bit (same mesh) —
    for the generic kernels AND the batch samplers (ChEES's Halton jitter
    is indexed by absolute draw number; MEADS re-derives its adaptation
    from the chain states each step)."""
    from aehmc_tpu.parallel import sample_sharded

    logprob_fn = std_normal()
    key = jax.random.PRNGKey(5)
    qs = jax.random.normal(jax.random.PRNGKey(6), (8, 2))
    common = dict(
        num_samples=30,
        num_warmup=40,
        algorithm=algorithm,
        checkpoint_every=10,
    )

    full = sample_sharded(
        key, logprob_fn, qs,
        checkpoint_path=str(tmp_path / "full.npz"), **common,
    )

    path = str(tmp_path / "run.npz")
    crashed = sample_sharded(
        key, logprob_fn, qs,
        checkpoint_path=path, _crash_after_segments=1, **common,
    )
    assert crashed is None  # simulated kill after segment 1
    resumed = sample_sharded(
        key, logprob_fn, qs, checkpoint_path=path, resume=True, **common,
    )

    np.testing.assert_array_equal(
        np.asarray(full.positions), np.asarray(resumed.positions)
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(full.final_state),
        jax.tree_util.tree_leaves(resumed.final_state),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(
        jax.tree_util.tree_leaves(full.diagnostics),
        jax.tree_util.tree_leaves(resumed.diagnostics),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(full.step_size) == float(resumed.step_size)
    np.testing.assert_array_equal(
        np.asarray(full.inverse_mass_matrix),
        np.asarray(resumed.inverse_mass_matrix),
    )


def test_checkpoint_every_validation():
    from aehmc_tpu.parallel import sample_sharded

    logprob_fn = std_normal()
    qs = jnp.zeros((4, 2))
    try:
        sample_sharded(
            jax.random.PRNGKey(0), logprob_fn, qs, num_samples=4,
            num_warmup=0, checkpoint_every=2,
        )
        raise AssertionError("expected ValueError")
    except ValueError:
        pass


def test_orbax_roundtrip_pytree(tmp_path):
    """The Orbax path (directory target) restores sharded-capable pytrees."""
    state = {
        "position": jnp.arange(8.0).reshape(2, 4),
        "step": jnp.asarray(7, jnp.int32),
    }
    path = str(tmp_path / "orbax_ckpt")
    checkpoint.save(path, state)
    restored = checkpoint.restore(path, jax.tree_util.tree_map(jnp.zeros_like, state))
    np.testing.assert_array_equal(restored["position"], state["position"])
    assert int(restored["step"]) == 7


def _assert_result_bitwise(a, b):
    np.testing.assert_array_equal(
        np.asarray(a.positions), np.asarray(b.positions)
    )
    for x, y in zip(
        jax.tree_util.tree_leaves(a.final_state),
        jax.tree_util.tree_leaves(b.final_state),
    ):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(
        np.asarray(a.step_size), np.asarray(b.step_size)
    )
    np.testing.assert_array_equal(
        np.asarray(a.inverse_mass_matrix), np.asarray(b.inverse_mass_matrix)
    )


@pytest.mark.parametrize("resume_devices", [4, 1])
def test_sample_sharded_checkpoint_resume_cross_mesh(
    tmp_path, resume_devices
):
    """Preemption/elasticity (SURVEY.md par.5 checkpoint bullet): a snapshot
    saved on an 8-device mesh resumes on a 4- or 1-device mesh.  Snapshots
    store the full logical arrays (the .npz save gathers shards), the
    resume call re-pins them with the NEW mesh's sharding, and all pooled
    reductions use fixed-tree pairwise orders that never observe the
    device layout (tests/test_parallel.py mesh-shape determinism) — so
    the re-sharded resume equals the uninterrupted 8-device run bitwise."""
    from aehmc_tpu.parallel import make_mesh, sample_sharded

    logprob_fn = std_normal()
    key = jax.random.PRNGKey(21)
    qs = jax.random.normal(jax.random.PRNGKey(22), (16, 2))
    common = dict(
        num_samples=30, num_warmup=40, algorithm="nuts",
        checkpoint_every=10,
    )

    full = sample_sharded(
        key, logprob_fn, qs, mesh=make_mesh(),
        checkpoint_path=str(tmp_path / "full.npz"), **common,
    )
    path = str(tmp_path / "run.npz")
    crashed = sample_sharded(
        key, logprob_fn, qs, mesh=make_mesh(),
        checkpoint_path=path, _crash_after_segments=1, **common,
    )
    assert crashed is None
    resumed = sample_sharded(
        key, logprob_fn, qs, mesh=make_mesh(resume_devices),
        checkpoint_path=path, resume=True, **common,
    )
    _assert_result_bitwise(full, resumed)


def test_sample_sharded_warmup_checkpoint_resume_cross_mesh(tmp_path):
    """A run killed MID-WARMUP on the 8-device mesh resumes on a 4-device
    mesh from the warmup snapshot and still reproduces the uninterrupted
    8-device run bit for bit."""
    import os

    from aehmc_tpu.parallel import make_mesh, sample_sharded

    logprob_fn = std_normal()
    key = jax.random.PRNGKey(23)
    qs = jax.random.normal(jax.random.PRNGKey(24), (16, 2))
    common = dict(
        num_samples=20, num_warmup=35, algorithm="nuts",
        checkpoint_every=10,
    )

    full = sample_sharded(
        key, logprob_fn, qs, mesh=make_mesh(),
        checkpoint_path=str(tmp_path / "full.npz"), **common,
    )
    path = str(tmp_path / "run.npz")
    crashed = sample_sharded(
        key, logprob_fn, qs, mesh=make_mesh(),
        checkpoint_path=path, _crash_after_warmup_segments=2, **common,
    )
    assert crashed is None  # killed during warmup
    assert os.path.exists(path[: -len(".npz")] + "_warmup.npz")
    resumed = sample_sharded(
        key, logprob_fn, qs, mesh=make_mesh(4),
        checkpoint_path=path, resume=True, **common,
    )
    _assert_result_bitwise(full, resumed)
