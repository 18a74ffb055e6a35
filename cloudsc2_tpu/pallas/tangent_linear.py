# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""GPU kernel for the tangent-linear CLOUDSC2 scheme.

The reference ``cloudsc2_tl`` stencil
(``physics/tangent_linear/_stencils/cloudsc2.py:23-774``) on the
level-scan kernel; the per-level physics is
:func:`cloudsc2_tpu.physics.tangent_linear.tl_level`, shared with the
``lax.scan`` path.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from cloudsc2_tpu.pallas.levelscan import level_scan_pallas
from cloudsc2_tpu.pallas.nonlinear import check_kernel_dtype, kernel_inputs, with_crh
from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics.tangent_linear import TLCarry, tl_level

Array = jnp.ndarray

#: columns per block and warps per block, chosen on the card by
#: ``benchmarks/kernel_vs_scan.py`` (CHANGES.md, PR 1)
BLOCK_COLS = 256
NUM_WARPS = 4

LEVEL_OUTPUTS = (
    "tnd_t", "tnd_t_i", "tnd_q", "tnd_q_i", "tnd_ql", "tnd_ql_i",
    "tnd_qi", "tnd_qi_i", "clc", "clc_i", "covptot", "covptot_i",
    "fplsl", "fplsl_i", "fplsn", "fplsn_i",
)


def tangent_inputs(state: Dict[str, Array], dt: float) -> Dict[str, Array]:
    """The perturbation streams, folded like the forward ones
    (:func:`cloudsc2_tpu.pallas.nonlinear.kernel_inputs`)."""
    lu_i = state["lu_i"]
    return {
        "ap_i": state["ap_i"],
        "dp_i": state["aph_i"][1:] - state["aph_i"][:-1],
        "lu_next_i": jnp.concatenate(
            [lu_i[1:], jnp.zeros_like(lu_i[:1])], axis=0
        ),
        "lude_i": state["lude_i"],
        "mf_i": state["mfu_i"] + state["mfd_i"],
        "q2_i": state["q_i"] + dt * state["tnd_cml_q_i"] + state["supsat_i"],
        "ql_fg_i": state["ql_i"] + dt * state["tnd_cml_ql_i"],
        "qi_fg_i": state["qi_i"] + dt * state["tnd_cml_qi_i"],
        "qsat_i": state["qsat_i"],
        "t_fg_i": state["t_i"] + dt * state["tnd_cml_t_i"],
    }


@partial(jax.jit, static_argnames=(
    "dt", "c", "interpret", "block_cols", "num_warps",
))
def cloudsc2_tl_pallas(
    state: Dict[str, Array],
    dt: float,
    c: Constants,
    interpret: bool = False,
    block_cols: int = BLOCK_COLS,
    num_warps: int = NUM_WARPS,
) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Drop-in replacement for :func:`cloudsc2_tpu.physics.tangent_linear.
    cloudsc2_tl` backed by the GPU kernel (float32, any column count)."""
    check_kernel_dtype(state)
    ncols = state["ap"].shape[1]
    dtype = state["ap"].dtype
    level, col_inputs, scalars = kernel_inputs(state, dt, c)
    level.update(tangent_inputs(state, dt))
    col_inputs["aph_s_i"] = state["aph_i"][-1]
    evap = bool(c.LEVAPLS2 or c.LDRAIN1D)

    def body(carry, x, col, _k):
        carry, outs = tl_level(
            TLCarry(*carry), with_crh(x, col), col["aph_s"], col["aph_s_i"],
            col["trpaus"], dt, c,
        )
        return tuple(carry), outs

    # with the evaporation branch compiled out covptot and covptot_i are
    # identically zero: neither stream is written
    out_names = LEVEL_OUTPUTS if evap else tuple(
        n for n in LEVEL_OUTPUTS if n not in ("covptot", "covptot_i")
    )
    named = level_scan_pallas(
        body,
        level_inputs=level,
        col_inputs=col_inputs,
        scalar_inputs=scalars,
        out_names=out_names,
        ncarry=6,
        block_cols=block_cols,
        num_warps=num_warps,
        interpret=interpret,
        name="cloudsc2_tl",
    )

    zrow = jnp.zeros((1, ncols), dtype)
    tends = {}
    for name in ("t", "q", "ql", "qi"):
        tends[name] = named["tnd_" + name]
        tends[name + "_i"] = named["tnd_" + name + "_i"]
    zfull = jnp.zeros_like(named["clc"])
    diags = {
        n: named.get(n, zfull) for n in ("clc", "clc_i", "covptot", "covptot_i")
    }
    for n in ("fplsl", "fplsl_i", "fplsn", "fplsn_i"):
        diags[n] = jnp.concatenate([zrow, named[n]], axis=0)
    diags["fhpsl"] = -diags["fplsl"] * c.RLVTT
    diags["fhpsn"] = -diags["fplsn"] * c.RLSTT
    diags["fhpsl_i"] = -diags["fplsl_i"] * c.RLVTT
    diags["fhpsn_i"] = -diags["fplsn_i"] * c.RLSTT
    return tends, diags
