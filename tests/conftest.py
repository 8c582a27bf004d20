"""Test-session configuration.

Runs the suite on CPU with 8 virtual XLA devices (the standard fake-backend
trick for testing mesh sharding without accelerators — SURVEY.md §4) and
float64 enabled, mirroring the reference's float64 test policy (ref
conftest.py:4-10).  The platform override goes through ``jax.config``, which
wins over ``JAX_PLATFORMS``.

Set ``AEHMC_DEVICE_SUITE=1`` to skip the CPU/x64 forcing: the suite then
runs on the default backend (the GPU, float32), which is how
``chip_smoke.py`` runs the GPU-marked gates (tests/test_gpu_gates.py).
"""

import os

if os.environ.get("AEHMC_DEVICE_SUITE") != "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
