# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""GPU kernel for the nonlinear CLOUDSC2 scheme.

The reference ``cloudsc2_nl`` stencil
(``physics/nonlinear/_stencils/cloudsc2.py:24-399``) on the level-scan
kernel (:mod:`cloudsc2_tpu.pallas.levelscan`); the per-level physics is
:func:`cloudsc2_tpu.physics.nonlinear.nl_level`, shared with the
``lax.scan`` path, so the two implementations cannot drift.

The tropopause search (a cross-level reduction needed *before* level 0's
cloud-cover computation, reference ``cloudsc2.py:106-111``) cannot live in
the top-down sweep; it runs in plain jnp ahead of the kernel, fused by XLA
with the first-guess temperature.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from cloudsc2_tpu.pallas.levelscan import level_scan_pallas
from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics.nonlinear import (
    NLCarry,
    critical_rh_coeffs,
    nl_level,
    scalm_profile,
    tropopause_eta,
)

Array = jnp.ndarray

#: columns per block and warps per block, chosen on the card by
#: ``benchmarks/kernel_vs_scan.py`` (CHANGES.md, PR 1)
BLOCK_COLS = 256
NUM_WARPS = 4

LEVEL_OUTPUTS = (
    "tnd_t", "tnd_q", "tnd_ql", "tnd_qi", "clc", "covptot", "fplsl", "fplsn",
)


def check_kernel_dtype(state: Dict[str, Array]) -> None:
    """The kernels run in single precision; the ``lax.scan`` paths are the
    f64 implementation."""
    if state["ap"].dtype != jnp.float32:
        raise ValueError(
            f"the GPU kernels take float32 fields (got {state['ap'].dtype}); "
            "use impl='scan' for double precision"
        )


def kernel_inputs(state: Dict[str, Array], dt: float, c: Constants):
    """Level, column and scalar inputs shared by the NL kernel and the
    adjoint's reverse kernel.

    The interface pressures enter the scheme only as their difference
    ``dp``, the mass fluxes only as their sum ``mf``, and the species,
    accumulated tendencies and ``supsat`` only through the first-guess
    combines (``nl_level_pre`` accepts all of these), so each is one
    stream instead of several."""
    dtype = state["ap"].dtype
    eta = state["eta"].astype(dtype)
    t_fg = state["t"] + dt * state["tnd_cml_t"]
    lu = state["lu"]
    trpaus = tropopause_eta(eta, t_fg)
    level = {
        "ap": state["ap"],
        "dp": state["aph"][1:] - state["aph"][:-1],
        "lu_next": jnp.concatenate([lu[1:], jnp.zeros_like(lu[:1])], axis=0),
        "lude": state["lude"],
        "mf": state["mfu"] + state["mfd"],
        "q2": state["q"] + dt * state["tnd_cml_q"] + state["supsat"],
        "ql_fg": state["ql"] + dt * state["tnd_cml_ql"],
        "qi_fg": state["qi"] + dt * state["tnd_cml_qi"],
        "qsat": state["qsat"],
        "t_fg": t_fg,
    }
    col = dict(
        zip(("crh_rh2", "crh_deta1", "crh_rsq"), critical_rh_coeffs(trpaus)),
        trpaus=trpaus,
        aph_s=state["aph"][-1],
    )
    return level, col, {"eta": eta, "scalm": scalm_profile(eta, c)}


def with_crh(x: Dict[str, Array], col: Dict[str, Array]) -> Dict[str, Array]:
    """``x`` with the hoisted per-column critical-humidity coefficients."""
    return dict(
        x, crh_rh2=col["crh_rh2"], crh_deta1=col["crh_deta1"],
        crh_rsq=col["crh_rsq"],
    )


@partial(
    jax.jit,
    static_argnames=(
        "dt", "c", "interpret", "with_trajectory", "block_cols", "num_warps",
    ),
)
def cloudsc2_nl_pallas(
    state: Dict[str, Array],
    dt: float,
    c: Constants,
    interpret: bool = False,
    with_trajectory: bool = False,
    block_cols: int = BLOCK_COLS,
    num_warps: int = NUM_WARPS,
) -> Tuple[Dict[str, Array], ...]:
    """Drop-in replacement for :func:`cloudsc2_tpu.physics.nonlinear.
    cloudsc2_nl` backed by the GPU kernel (float32, any column count).

    ``with_trajectory=True`` also returns the carry *entering* each level
    (``c_rfl``, ``c_sfl`` and, with the evaporation branch on, ``c_cov``):
    the trajectory the adjoint's reverse sweep re-linearizes around.
    """
    check_kernel_dtype(state)
    ncols = state["ap"].shape[1]
    dtype = state["ap"].dtype
    level, col_inputs, scalars = kernel_inputs(state, dt, c)
    evap = bool(c.LEVAPLS2 or c.LDRAIN1D)

    def body(carry, x, col, _k):
        carry_in = carry
        carry, outs, _aux = nl_level(
            NLCarry(*carry), with_crh(x, col), col["aph_s"], col["trpaus"],
            dt, c,
        )
        if with_trajectory:
            outs["c_rfl"], outs["c_sfl"], outs["c_cov"] = carry_in
        return tuple(carry), outs

    # with the evaporation branch compiled out the covptot output is
    # identically zero and the TL/AD never read the covptot carry (it is
    # consumed only inside that branch), so neither stream is written
    out_names = LEVEL_OUTPUTS if evap else tuple(
        n for n in LEVEL_OUTPUTS if n != "covptot"
    )
    traj_names = ("c_rfl", "c_sfl") + (("c_cov",) if evap else ())
    if with_trajectory:
        out_names = out_names + traj_names
    named = level_scan_pallas(
        body,
        level_inputs=level,
        col_inputs=col_inputs,
        scalar_inputs=scalars,
        out_names=out_names,
        ncarry=3,
        block_cols=block_cols,
        num_warps=num_warps,
        interpret=interpret,
        name="cloudsc2_nl",
    )

    zrow = jnp.zeros((1, ncols), dtype)
    fplsl = jnp.concatenate([zrow, named["fplsl"]], axis=0)
    fplsn = jnp.concatenate([zrow, named["fplsn"]], axis=0)
    tends = {n: named["tnd_" + n] for n in ("t", "q", "ql", "qi")}
    diags = {
        "clc": named["clc"],
        "covptot": named["covptot"] if evap else jnp.zeros_like(named["clc"]),
        "fplsl": fplsl,
        "fplsn": fplsn,
        "fhpsl": -fplsl * c.RLVTT,
        "fhpsn": -fplsn * c.RLSTT,
    }
    if with_trajectory:
        return tends, diags, {n: named[n] for n in traj_names}
    return tends, diags
