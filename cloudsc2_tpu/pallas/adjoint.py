# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""GPU kernels for the adjoint CLOUDSC2 scheme.

The reference ``cloudsc2_ad`` stencil
(``physics/adjoint/_stencils/cloudsc2.py:24-996``) as two level-scan
kernels, mirroring its two ``computation`` phases:

1. **Forward sweep** — the NL kernel with ``with_trajectory=True``:
   recomputes the nonlinear trajectory and stores, per level, only the
   carry *entering* the level (rain/snow flux, precipitation cover).  The
   reference instead materializes ~35 full 3-D temporaries
   (``adjoint/_stencils/cloudsc2.py:133-476``); everything else is
   recomputed in the reverse sweep.
2. **Reverse sweep** — a bottom-up level scan (``reverse=True``) whose body
   is the *transpose of the tangent-linear level function*, obtained by
   ``jax.vjp`` of :func:`~cloudsc2_tpu.physics.tangent_linear.tl_level` at
   trace time inside the kernel: the TL is exactly linear in the
   perturbation arguments, so the VJP at zero is the exact adjoint —
   including the four ``LREGCL`` regularization factors the reference
   mirrors by hand (``:585-587, 751-757, 774-779, 829-832, 896-902``).
   Each reverse level re-runs the TL forward from the stored carry and
   back-propagates the 3 carry cotangents, held in registers.

The trajectory streams pass through device memory between the kernels.

Restriction: ``LPHYLIN=True``, so that the NL forward trajectory coincides
with the TL forward (the reference's linearized physics configuration);
:func:`cloudsc2_tpu.physics.adjoint.cloudsc2_ad` covers the rest.  The
precipitation-evaporation configurations (``LEVAPLS2`` / ``LDRAIN1D``) are
supported: the reverse sweep then also back-propagates onto the
surface-pressure perturbation ``aph_s_i`` (reference
``adjoint/_stencils/cloudsc2.py:969-986``), emitted as one extra
per-level cotangent stream and summed into ``aph_i[nlev]`` at assembly.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from cloudsc2_tpu.pallas.levelscan import level_scan_pallas
from cloudsc2_tpu.pallas.nonlinear import (
    check_kernel_dtype,
    cloudsc2_nl_pallas,
    kernel_inputs,
    with_crh,
)
from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics.tangent_linear import TLCarry, tl_level

Array = jnp.ndarray

#: columns per block and warps per block of the reverse kernel, chosen on
#: the card by ``benchmarks/kernel_vs_scan.py`` (CHANGES.md, PR 1); the
#: forward sweep uses the NL kernel's own
BLOCK_COLS = 128
NUM_WARPS = 2

#: tangent-input names whose cotangents the reverse kernel produces.
#: Folded bases: dp_i for the aph pair (aph_i[k] = dp_i[k-1] - dp_i[k]);
#: q2_i/ql_fg_i/qi_fg_i/t_fg_i for the first-guess combines — the raw
#: cotangents are exact linear images (coefficient 1 for the field and
#: supsat, dt for the accumulated tendency), expanded in XLA at assembly
XI_NAMES = (
    "ap_i", "dp_i", "lu_next_i", "lude_i", "mf_i",
    "q2_i", "ql_fg_i", "qi_fg_i", "qsat_i", "t_fg_i",
)
#: tangent outputs of tl_level that receive cotangent seeds
SEED_NAMES = (
    "tnd_t_i", "tnd_q_i", "tnd_ql_i", "tnd_qi_i",
    "clc_i", "covptot_i", "fplsl_i", "fplsn_i",
)


@partial(jax.jit, static_argnames=(
    "dt", "c", "interpret", "block_cols", "num_warps",
))
def cloudsc2_ad_pallas(
    state: Dict[str, Array],
    dt: float,
    c: Constants,
    interpret: bool = False,
    block_cols: int = BLOCK_COLS,
    num_warps: int = NUM_WARPS,
) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Drop-in replacement for :func:`cloudsc2_tpu.physics.adjoint.
    cloudsc2_ad` backed by the forward + reverse GPU kernels."""
    if not c.LPHYLIN:
        raise ValueError(
            "cloudsc2_ad_pallas requires LPHYLIN=True (the kernel's forward "
            "sweep is the NL kernel, whose trajectory coincides with the TL "
            "forward only under linearized physics); use impl='scan'"
        )
    check_kernel_dtype(state)
    ncols = state["ap"].shape[1]
    dtype = state["ap"].dtype
    evap = bool(c.LEVAPLS2 or c.LDRAIN1D)

    tends_f, diags_f, traj = cloudsc2_nl_pallas(
        state, dt, c, interpret=interpret, with_trajectory=True
    )

    level, col_inputs, scalars = kernel_inputs(state, dt, c)
    level.update(_seeds(state, c))
    level.update(traj)
    named = level_scan_pallas(
        _make_rev_body(dt, c, evap),
        level_inputs=level,
        col_inputs=col_inputs,
        scalar_inputs=scalars,
        out_names=tuple("cot_" + n for n in XI_NAMES)
        + (("cot_aph_s_i",) if evap else ()),
        ncarry=3,
        block_cols=block_cols,
        num_warps=num_warps,
        reverse=True,
        interpret=interpret,
        name="cloudsc2_ad_reverse",
    )
    return _assemble(named, tends_f, diags_f, ncols, dtype, dt, c, evap)


def _seeds(state: Dict[str, Array], c: Constants) -> Dict[str, Array]:
    """Cotangent seed streams.  The interface-flux seeds fold their
    enthalpy partners (fhpsl = -RLVTT * fplsl) and shift one level (output
    k is interface k+1).  With the evaporation branch compiled out the
    covptot output is identically zero, so its seed cannot reach any input
    cotangent and is not streamed."""
    seeds = {
        "s_tnd_t_i": state["tnd_t_i"],
        "s_tnd_q_i": state["tnd_q_i"],
        "s_tnd_ql_i": state["tnd_ql_i"],
        "s_tnd_qi_i": state["tnd_qi_i"],
        "s_clc_i": state["clc_i"],
        "s_fplsl_i": state["fplsl_i"][1:] - c.RLVTT * state["fhpsl_i"][1:],
        "s_fplsn_i": state["fplsn_i"][1:] - c.RLSTT * state["fhpsn_i"][1:],
    }
    if c.LEVAPLS2 or c.LDRAIN1D:
        seeds["s_covptot_i"] = state["covptot_i"]
    return seeds


def _make_rev_body(dt: float, c: Constants, evap: bool):
    """The reverse level body: ``jax.vjp`` of the exactly-linear TL level,
    re-linearized around the stored forward carry (``x["c_*"]``)."""

    def body(cot, x, col, _k):
        z = jnp.zeros_like(x["ap"])
        xfwd = with_crh(
            {n: x[n] for n in (
                "ap", "dp", "lu_next", "lude", "mf", "q2", "ql_fg", "qi_fg",
                "qsat", "t_fg", "eta", "scalm",
            )},
            col,
        )

        def lin(ci, xi, aph_s_i):
            # c_cov is absent when the evaporation branch is off (the TL
            # never reads the covptot carry then)
            carry = TLCarry(x["c_rfl"], x["c_sfl"], x.get("c_cov", z), *ci)
            carry_out, outs = tl_level(
                carry, {**xfwd, **xi}, col["aph_s"], aph_s_i, col["trpaus"],
                dt, c,
            )
            return (
                (carry_out.rfl_i, carry_out.sfl_i, carry_out.covptot_i),
                tuple(outs[n] for n in SEED_NAMES),
            )

        zi = {n: z for n in XI_NAMES}
        _, vjp = jax.vjp(lin, (z, z, z), zi, z)
        ci_cot, xi_cot, aph_s_cot = vjp(
            (tuple(cot), tuple(x.get("s_" + n, z) for n in SEED_NAMES))
        )
        outs = {"cot_" + n: xi_cot[n] for n in XI_NAMES}
        if evap:
            # per-level contribution to the surface-pressure cotangent
            # (tl_level's evaporation branch reads aph_s_i at every level)
            outs["cot_aph_s_i"] = aph_s_cot
        return tuple(ci_cot), outs

    return body


def _assemble(named, tends_f, diags_f, ncols, dtype, dt, c, evap):
    """Assemble the component outputs (adjoint/microphysics.py:150-218).

    The folded cotangent bases expand by linearity of the first-guess
    combines: q2 = q + dt*tnd_cml_q + supsat gives cot_q = cot_supsat =
    cot_q2 and cot_tnd_cml_q = dt*cot_q2 (supsat keeps coefficient 1 —
    the documented exact-transpose deviation, see PARITY.md), and
    likewise for ql/qi/t.
    """
    zrow = jnp.zeros((1, ncols), dtype)
    cot = {n: named["cot_" + n] for n in XI_NAMES}
    tends = dict(tends_f)
    tends["cml_t_i"] = dt * cot["t_fg_i"]
    tends["cml_q_i"] = dt * cot["q2_i"]
    tends["cml_ql_i"] = dt * cot["ql_fg_i"]
    tends["cml_qi_i"] = dt * cot["qi_fg_i"]

    # dp = aph1 - aph0  =>  aph_i[k] = dp_i[k-1] - dp_i[k] (zero outside)
    aph_i = jnp.concatenate([zrow, cot["dp_i"]]) - jnp.concatenate(
        [cot["dp_i"], zrow]
    )
    if evap:
        # every level's evaporation branch reads aph_s = aph[nlev]
        # (reference ``adjoint/_stencils/cloudsc2.py:969-986``)
        aph_i = aph_i.at[-1].add(jnp.sum(named["cot_aph_s_i"], axis=0))
    diags = dict(diags_f)
    diags.update(
        ap_i=cot["ap_i"],
        aph_i=aph_i,
        t_i=cot["t_fg_i"],
        q_i=cot["q2_i"],
        qsat_i=cot["qsat_i"],
        ql_i=cot["ql_fg_i"],
        qi_i=cot["qi_fg_i"],
        lu_i=jnp.concatenate([zrow, cot["lu_next_i"][:-1]]),
        lude_i=cot["lude_i"],
        mfd_i=cot["mf_i"],
        mfu_i=cot["mf_i"],
        supsat_i=cot["q2_i"],
    )
    return tends, diags
