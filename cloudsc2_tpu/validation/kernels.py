# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Kernel-against-scan comparison: the inputs each scheme takes and the
per-field errors of one implementation against another (the two
implementations come from :func:`cloudsc2_tpu.dispatch.scheme_fns`).

Shared by the kernel tests, ``chip_smoke.py`` and
``benchmarks/kernel_vs_scan.py``, so that all three build the same
problems and measure errors the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp
import numpy as np

from cloudsc2_tpu import iox
from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics.diagnostics import eta_levels
from cloudsc2_tpu.physics.increment import state_increment
from cloudsc2_tpu.physics.saturation import saturation


def scheme_state(
    scheme: str, ncols: int, dtype: Any, c: Constants, *, nlev: int = 137,
    seed: int = 0,
) -> Tuple[Dict[str, jnp.ndarray], float]:
    """The synthetic state ``scheme`` runs on, as the drivers assemble it:
    NL inputs with eta and qsat; for the TL the 1 % perturbation of the
    symmetry protocol; for the AD also the TL outputs as cotangent seeds
    (reference ``adjoint/validation.py:132-151``)."""
    from cloudsc2_tpu.physics.tangent_linear import cloudsc2_tl
    from cloudsc2_tpu.validation.symmetry import DIAG_NAMES, TEND_NAMES

    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=seed, dtype=dtype)
    s = {k: jnp.asarray(v, dtype) for k, v in state.items()}
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    if scheme == "nl":
        return s, dt
    s.update(state_increment(s, 0.01, ignore_supsat=True))
    if scheme == "ad":
        tends, diags = cloudsc2_tl(s, dt, c)
        for n in TEND_NAMES:
            s["tnd_" + n] = tends[n]
            s["tnd_" + n + "_i"] = tends[n + "_i"]
        for n in DIAG_NAMES:
            s[n + "_i"] = diags[n + "_i"]
    return s, dt


def field_errors(ref, got) -> Dict[str, Tuple[float, float]]:
    """Per output field of ``(tendencies, diagnostics)``: the maximum
    absolute difference, and that difference over the field's largest
    magnitude (a relative error that stays finite where a field crosses
    zero).  Both output dicts of ``got`` must hold every field of ``ref``."""
    out = {}
    for r, g in zip(ref, got):
        for n in r:
            a = np.asarray(r[n], np.float64)
            b = np.asarray(g[n], np.float64)
            if a.shape != b.shape:
                raise ValueError(f"field {n!r}: shape {b.shape} != {a.shape}")
            err = float(np.abs(a - b).max()) if a.size else 0.0
            if not np.isfinite(b).all():
                err = float("inf")
            scale = float(np.abs(a).max()) if a.size else 0.0
            out[n] = (err, err / scale if scale > 0 else err)
    return out
