
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Test configuration: CPU backend, float64, virtual 8-device mesh.

Correctness tests run on the CPU backend in double precision (the reference
validates in f64, ``drivers/config.py:31-44``); the multi-device sharding
tests use a virtual 8-device CPU mesh via
``--xla_force_host_platform_device_count`` so distribution is testable
without several GPUs (SURVEY.md section 4).  The GPU path runs on the card
through ``chip_smoke.py``.
"""
import os

# force CPU even where JAX would pick an accelerator, and override through
# jax.config as well in case jax was imported before this file ran
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cloudsc2_tpu import iox, make_constants  # noqa: E402


@pytest.fixture(scope="session")
def synth():
    """Deterministic synthetic input: (grid, state, dt)."""
    grid, state, dt = iox.synthesize_input(ncols=100, nlev=137, seed=0)
    return grid, state, dt


@pytest.fixture(scope="session")
def constants():
    """Driver-default constants: LPHYLIN=True, LDRAIN1D=False (run_nonlinear.py:84-108)."""
    return make_constants(lphylin=True, ldrain1d=False)


@pytest.fixture(scope="session")
def state_with_qsat(synth, constants):
    """State augmented with eta and qsat, as the drivers assemble it."""
    import jax.numpy as jnp

    from cloudsc2_tpu.physics.diagnostics import eta_levels
    from cloudsc2_tpu.physics.saturation import saturation

    grid, state, dt = synth
    state = {k: jnp.asarray(v) for k, v in state.items()}
    state["eta"] = eta_levels(state["ap"], state["aph"])
    state["qsat"] = saturation(state["ap"], state["t"], kflag=1, lphylin=True, c=constants)
    return grid, state, dt
