"""``chip_smoke.py`` without a card: it refuses to run on the CPU, and its
phase functions run end to end at tiny sizes on the CPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY = dict(num_chains=64, dim=16, num_points=64)


def test_exits_nonzero_without_a_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_without_the_package(tmp_path):
    """Alone in a directory, the script finds no library and prints no
    result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_main_path_phase():
    res = chip_smoke.phase_main(**TINY, num_warmup=100, num_samples=100)
    assert res.positions.shape == (100, 64, 16)
    assert np.isfinite(np.asarray(res.positions)).all()


def test_algorithms_phase():
    chip_smoke.phase_algorithms(**TINY, num_warmup=60, num_samples=60)


def test_four_card_phase_on_virtual_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    chip_smoke.phase_four(num_chains=64, dim=16, num_points=64,
                          num_warmup=100, num_samples=100,
                          devices=jax.devices()[:4])


def test_failed_check_is_an_error():
    with pytest.raises(chip_smoke.PhaseError, match="boom"):
        chip_smoke.check(False, "boom")
