
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLOUDSC2 tangent-linear scheme, JAX formulation.

JAX re-implementation of the reference ``cloudsc2_tl`` gtscript stencil
(``src/cloudsc2_gt4py/physics/tangent_linear/_stencils/cloudsc2.py:23-774``)
and its component (``physics/tangent_linear/microphysics.py:46-242``).

The hand-derived tangent linear propagates a perturbation ``x_i`` alongside
every forward intermediate ``x`` (dual-number style).  It is NOT the exact
Jacobian-vector product of the nonlinear scheme: four ``LREGCL``
regularization switches deliberately damp perturbation growth

* cloud-fraction factor ``yyy = min(0.3, 3.5*sqrt(...))``  (reference :295-301)
* subsidence ``dqc_i *= 0.1``                              (reference :367-368)
* autoconversion ``ckcodtl/100``, ``ckcodti/100``          (reference :444-487)
* clipping ``dq_i *= 0.7``                                 (reference :667-668)

With ``LREGCL=False`` this operator equals ``jax.jvp`` of the nonlinear
scheme up to rounding (cross-checked in ``tests/test_tl.py``), which is how
the Taylor test runs it (reference ``tangent_linear/validation.py:84-85``).

Structure mirrors :mod:`cloudsc2_tpu.physics.nonlinear`: a ``lax.scan`` over
levels; carried state ``(rfl, sfl, covptot)`` plus their perturbations.
Unlike the NL scheme, the TL stencil always uses the linearized-physics
``tanh`` water fraction and always clips ``esdp`` (reference :189-205).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics.cuadjtqs import cuadjtqs_tl
from cloudsc2_tpu.physics.fastmath import fmask, sel0
from cloudsc2_tpu.physics.nonlinear import critical_rh, prepare_level_inputs, tropopause_eta

Array = jnp.ndarray


class TLCarry(NamedTuple):
    rfl: Array
    sfl: Array
    covptot: Array
    rfl_i: Array
    sfl_i: Array
    covptot_i: Array


def tl_level_pre(
    x: Dict[str, Array],
    aph_s: Array,
    trpaus: Array,
    dt: float,
    c: Constants,
) -> Dict[str, Array]:
    """Carry-independent portion of one TL level (phase A).

    The tangent-linear counterpart of :func:`cloudsc2_tpu.physics.
    nonlinear.nl_level_pre`: everything up to (and excluding) the
    precipitation-overlap / snow-melt recurrence, plus the melt constants,
    the liquid autoconversion and the melt-free half of the ice
    autoconversion (reference ``tangent_linear/_stencils/cloudsc2.py:
    137-386, 399-412, 429-471``).  All three in-loop LREGCL switches live
    here.  Keys that would shadow a raw level input are suffixed (``lude_s``, ``ql_fg``, ``qi_fg``,
    ``qsat_sups``).
    """
    ap = x["ap"]
    ap_i = x["ap_i"]
    qsat_in = x["qsat"]
    qsat_in_i = x["qsat_i"]

    # first-guess state and perturbations (reference :137-156)
    t = x["t_fg"]
    # the raw species / accumulated tendencies / supsat (and their
    # perturbations) enter ONLY through these combines, so the kernel
    # wrapper streams the precomputed first-guess values (7 streams
    # instead of 16); the combine is bit-identical either way
    t_i = x["t_fg_i"] if "t_fg_i" in x else x["t_i"] + dt * x["tnd_cml_t_i"]
    q = x["q2"] if "q2" in x else x["q"] + dt * x["tnd_cml_q"] + x["supsat"]
    q_i = (
        x["q2_i"] if "q2_i" in x
        else x["q_i"] + dt * x["tnd_cml_q_i"] + x["supsat_i"]
    )
    ql = x["ql_fg"] if "ql_fg" in x else x["ql"] + dt * x["tnd_cml_ql"]
    ql_i = x["ql_fg_i"] if "ql_fg_i" in x else x["ql_i"] + dt * x["tnd_cml_ql_i"]
    qi = x["qi_fg"] if "qi_fg" in x else x["qi"] + dt * x["tnd_cml_qi"]
    qi_i = x["qi_fg_i"] if "qi_fg_i" in x else x["qi_i"] + dt * x["tnd_cml_qi_i"]

    # constants (reference :158-168)
    ckcodtl = 2.0 * c.RKCONV * dt
    ckcodti = 5.0 * c.RKCONV * dt
    ckcodtla = ckcodtl / 100.0
    ckcodtia = ckcodti / 100.0
    cons2 = 1.0 / (c.RG * dt)
    cons3 = c.RLVTT / c.RCPD
    meltp2 = c.RTT + 2.0
    scalm = x["scalm"]

    # thermodynamic coefficients, inverse form (reference :170-180)
    # interface pressures enter only through their difference; the kernel
    # wrapper streams precomputed dp/dp_i (see physics/nonlinear.py)
    dp = x["dp"] if "dp" in x else x["aph1"] - x["aph0"]
    dp_i = x["dp_i"] if "dp_i" in x else x["aph1_i"] - x["aph0_i"]
    # moist heat capacity D and one shared reciprocal; the derivative is
    # -D_i/D^2 = -D_i*zz*zz (quotient rule via the shared reciprocal — the
    # same strength reduction as nl_level_pre, exact algebra, ~1 ulp)
    zd = c.RCPD + c.RCPD * c.RVTMP2 * q
    zd_i = c.RCPD * c.RVTMP2 * q_i
    zz = 1.0 / zd
    zz_i = -zd_i * (zz * zz)
    lfdcp = c.RLMLT * zz
    lfdcp_i = c.RLMLT * zz_i
    lsdcp = c.RLSTT * zz
    lsdcp_i = c.RLSTT * zz_i
    lvdcp = c.RLVTT * zz
    lvdcp_i = c.RLVTT * zz_i

    # dqs/dT correction factor; always the tanh branch here (reference :189-222)
    ms = c.MASK_SELECT
    cold = t < c.RTT
    # sech^2 = 1 - tanh^2 (the reference's 1/cosh^2, :196; tanh-based so the
    # kernel lowering needs no cosh primitive)
    th = jnp.tanh(0.17 * (t - c.RLPTRC))
    fwat = jnp.where(cold, 0.545 * (th + 1.0), 1.0)
    fwat_i = sel0(fmask(cold, t) if ms else cold, 0.545 * 0.17 * t_i * (1.0 - th * th))
    z3es = jnp.where(cold, c.R3IES, c.R3LES)
    z4es = jnp.where(cold, c.R4IES, c.R4LES)
    # one reciprocal each of (t - R4LES) and (t - R4IES) serves the
    # saturation-pressure exponent argument AND the four dqs/dT factors
    # (same sharing as nl_level_pre: facw = R5LES*rl^2, facw_i = -2*R5LES*
    # t_i*rl^3), and one reciprocal of ap serves esdp and its perturbation
    # — 10 divides fold into 3 reciprocals
    rl = 1.0 / (t - c.R4LES)
    ri = 1.0 / (t - c.R4IES)
    rz4es = jnp.where(cold, ri, rl)
    rap = 1.0 / ap
    foeew = c.R2ES * jnp.exp(z3es * (t - c.RTT) * rz4es)
    foeew_i = z3es * (c.RTT - z4es) * t_i * foeew * (rz4es * rz4es)
    esdp = foeew * rap
    esdp_i = (foeew_i - esdp * ap_i) * rap
    # where(esdp > ZQMAX, ZQMAX, esdp) is a plain min (the NL form); the
    # perturbation vanishes on the clipped branch
    noclip = esdp <= c.ZQMAX
    esdp = jnp.minimum(esdp, c.ZQMAX)
    esdp_i = sel0(fmask(noclip, esdp) if ms else noclip, esdp_i)

    facw = c.R5LES * (rl * rl)
    facw_i = -2.0 * c.R5LES * t_i * (rl * rl * rl)
    faci = c.R5IES * (ri * ri)
    faci_i = -2.0 * c.R5IES * t_i * (ri * ri * ri)
    fac = fwat * facw + (1.0 - fwat) * faci
    fac_i = fwat_i * (facw - faci) + fwat * facw_i + (1.0 - fwat) * faci_i
    cor = 1.0 / (1.0 - c.RETV * esdp)
    cor_i = c.RETV * esdp_i * (cor * cor)
    dqsdtemp = fac * cor * qsat_in
    dqsdtemp_i = fac_i * cor * qsat_in + fac * cor_i * qsat_in + fac * cor * qsat_in_i
    corqs = 1.0 + cons3 * dqsdtemp
    corqs_i = cons3 * dqsdtemp_i

    # clipped state (reference :224-230); the value select is a plain min
    # (the NL form), the perturbation select stays two-sided
    overs = q > qsat_in
    qlim = jnp.minimum(q, qsat_in)
    qlim_i = jnp.where(overs, qsat_in_i, q_i)

    # critical humidity and ice supersaturation (reference :232-265)
    coeffs = (
        (x["crh_rh2"], x["crh_deta1"], x["crh_rsq"]) if "crh_rh2" in x else None
    )
    crh2 = critical_rh(x["eta"], trpaus, coeffs)
    cold_ice = t < c.RTICE
    supsat_fac = jnp.where(cold_ice, 1.8 - 0.003 * t, 1.0)
    supsat_fac_i = sel0(fmask(cold_ice, t) if ms else cold_ice, -0.003 * t_i)
    qsat = qsat_in * supsat_fac
    qsat_i = qsat_in_i * supsat_fac + qsat_in * supsat_fac_i
    qcrit = crh2 * qsat
    qcrit_i = crh2 * qsat_i

    # cloud cover and its perturbation (reference :267-306)
    qt = q + ql + qi
    qt_i = q_i + ql_i + qi_i
    low = qt < qcrit
    high = qt >= qsat
    mid = jnp.logical_not(low | high)
    qpd = qsat - qt
    qpd_i = qsat_i - qt_i
    qcd = qsat - qcrit
    qcd_i = qsat_i - qcrit_i
    denom = qcd - scalm * (qt - qcrit)
    denom_safe = jnp.where(mid, denom, 1.0)
    # one reciprocal of the safe denominator serves the ratio and the
    # quotient-rule term of its perturbation
    rdenom = 1.0 / denom_safe
    mid_ = fmask(mid, qpd) if ms else mid
    ratio = sel0(mid_, qpd * rdenom)
    tmp1 = jnp.sqrt(ratio)
    clc_mid = 1.0 - tmp1
    # 1/tmp1 as a single rsqrt of the guarded ratio (one op instead of
    # sqrt + divide; the guard value 1.0 keeps inactive lanes finite)
    rtmp1 = jax.lax.rsqrt(jnp.where(mid, ratio, 1.0))
    clc_mid_i = (
        -0.5
        * rtmp1
        * (qpd_i * denom - qpd * (qcd_i - scalm * (qt_i - qcrit_i)))
        * (rdenom * rdenom)
    )
    if c.LREGCL:
        # regularization of the cloud-fraction perturbation (reference :294-301)
        qcd_safe = jnp.where(mid, qcd, 1.0)
        rat = qpd / qcd_safe
        yyy = jnp.minimum(
            0.3,
            3.5
            * jnp.sqrt(jnp.maximum(rat * (1.0 - scalm * (1.0 - rat)) ** 3.0, 0.0))
            / (1.0 - scalm),
        )
        clc_mid_i = clc_mid_i * yyy
    qc_mid = (scalm * qpd + (1.0 - scalm) * qcd) * clc_mid**2.0
    qc_mid_i = (scalm * qpd_i + (1.0 - scalm) * qcd_i) * clc_mid**2.0 + 2.0 * (
        scalm * qpd + (1.0 - scalm) * qcd
    ) * clc_mid * clc_mid_i

    qc_high = (1.0 - scalm) * (qsat - qcrit)
    qc_high_i = (1.0 - scalm) * (qsat_i - qcrit_i)
    if ms:
        # exclusive regime masks (see nl_level_pre): one mask conversion
        # pair replaces eight vector selects, bit-identically
        high_ = fmask(high, qpd)
        clc = high_ + mid_ * clc_mid
        clc_i = mid_ * clc_mid_i
        qc = high_ * qc_high + mid_ * qc_mid
        qc_i = high_ * qc_high_i + mid_ * qc_mid_i
    else:
        clc = jnp.where(low, 0.0, jnp.where(high, 1.0, clc_mid))
        clc_i = jnp.where(low, 0.0, jnp.where(high, 0.0, clc_mid_i))
        qc = jnp.where(low, 0.0, jnp.where(high, qc_high, qc_mid))
        qc_i = jnp.where(low, 0.0, jnp.where(high, qc_high_i, qc_mid_i))

    # convective component (reference :308-325); one reciprocal each of dp
    # and lu1_safe serves value + perturbation (5 divides fold into 2)
    rdp = 1.0 / dp
    gdp = c.RG * rdp
    gdp_i = -c.RG * dp_i * (rdp * rdp)
    lude = dt * x["lude"] * gdp
    lude_i = dt * (x["lude_i"] * gdp + x["lude"] * gdp_i)
    lu1 = x["lu_next"]
    lu1_i = x["lu_next_i"]
    lo1 = (lude >= c.RLMIN) & (lu1 >= c.ZEPS2)
    lu1_safe = jnp.where(lo1, lu1, 1.0)
    rlu1 = 1.0 / lu1_safe
    tmp2 = jnp.exp(-lude * rlu1)
    clc_i_conv = -clc_i * (1.0 - tmp2) + (1.0 - clc) * tmp2 * (
        (lude_i - lude * lu1_i * rlu1) * rlu1
    )
    lo1_ = fmask(lo1, lude) if ms else lo1
    clc_i = clc_i + sel0(lo1_, clc_i_conv)
    clc = clc + sel0(lo1_, (1.0 - clc) * (1.0 - tmp2))
    qc = qc + sel0(lo1_, lude)
    qc_i = qc_i + sel0(lo1_, lude_i)

    # compensating subsidence (reference :327-373); 1/t = RD*fac1 and
    # 1/rho = RD*t*rap (nl_level_pre's fac4), so the rho_i quotient term
    # and the two sub divides need no further division
    fac1 = 1.0 / (c.RD * t)
    rho = ap * fac1
    rho_i = (ap_i - ap * t_i * (c.RD * fac1)) * fac1
    fac2 = 1.0 / (ap - c.RETV * foeew)
    rodqsdp = -rho * qsat_in * fac2
    rodqsdp_i = (
        -rho_i * qsat_in
        - rho * qsat_in_i
        + rho * qsat_in * (ap_i - c.RETV * foeew_i) * fac2
    ) * fac2
    ldcp = fwat * lvdcp + (1.0 - fwat) * lsdcp
    ldcp_i = fwat_i * (lvdcp - lsdcp) + fwat * lvdcp_i + (1.0 - fwat) * lsdcp_i
    fac3 = 1.0 / (1.0 + ldcp * dqsdtemp)
    dtdzmo = c.RG * (1.0 / c.RCPD - ldcp * rodqsdp) * fac3
    dtdzmo_i = (
        -(
            c.RG * (ldcp_i * rodqsdp + ldcp * rodqsdp_i)
            + dtdzmo * (ldcp_i * dqsdtemp + ldcp * dqsdtemp_i)
        )
        * fac3
    )
    dqsdz = dqsdtemp * dtdzmo - c.RG * rodqsdp
    dqsdz_i = dqsdtemp_i * dtdzmo + dqsdtemp * dtdzmo_i - c.RG * rodqsdp_i

    fac4 = c.RD * t * rap  # 1/rho, division-free (nl_level_pre's fac4)
    # mass fluxes enter only as their sum (value and perturbation): one
    # ``mf``/``mf_i`` stream pair in the kernel wrappers
    mf = x["mf"] if "mf" in x else x["mfu"] + x["mfd"]
    mf_i = x["mf_i"] if "mf_i" in x else x["mfu_i"] + x["mfd_i"]
    sub = dt * dqsdz * mf * fac4
    lo3 = sub < qc
    dqc = jnp.where(lo3, sub, qc)
    dqc_i_sub = (
        dt * (dqsdz_i * mf + dqsdz * mf_i)
        - dqc * rho_i
    ) * fac4
    if c.LREGCL:
        dqc_i_sub = dqc_i_sub * 0.1  # reference :367-368
    # qc - dqc == where(lo3, qc - sub, 0) and likewise for the
    # perturbation: two masked subtracts instead of select+subtract pairs
    lo3_ = fmask(lo3, qc) if ms else lo3
    qc = sel0(lo3_, qc - sub)
    qc_i = sel0(lo3_, qc_i - dqc_i_sub)

    # new condensate and condensation rates (reference :375-386)
    qlwc = qc * fwat
    qlwc_i = qc_i * fwat + qc * fwat_i
    qiwc = qc * (1.0 - fwat)
    qiwc_i = qc_i * (1.0 - fwat) - qc * fwat_i
    rdt = 1.0 / dt  # dt is static: the reciprocal is a compile-time constant
    condl = (qlwc - ql) * rdt
    condl_i = (qlwc_i - ql_i) * rdt
    condi = (qiwc - qi) * rdt
    condi_i = (qiwc_i - qi_i) * rdt


    # melt constants (reference :399-412; the min() against the snow-flux
    # carry stays in phase B).  Division-free as in nl_level_pre: cons =
    # cons2*dp/lfdcp = (cons2/RLMLT)*dp*zd (lfdcp = RLMLT/zd), its
    # derivative by the product rule, and the reciprocal the melt
    # temperature update needs is rcons = 1/cons = dt*gdp*lfdcp exactly
    cons = (cons2 / c.RLMLT) * dp * zd
    cons_i = (cons2 / c.RLMLT) * (dp_i * zd + dp * zd_i)
    rcons = dt * gdp * lfdcp
    rcons_i = dt * (gdp_i * lfdcp + gdp * lfdcp_i)
    # z2s as the NL form cons*max(t - meltp2, 0) (bit-identical: cons >= 0)
    warm = t > meltp2
    z2s = cons * jnp.maximum(t - meltp2, 0.0)
    z2s_i = sel0(fmask(warm, t) if ms else warm, cons_i * (t - meltp2) + cons * t_i)

    # autoconversion of cloud water/ice (reference :429-503)
    act = clc > c.ZEPS2
    if c.LEVAPLS2 or c.LDRAIN1D:
        lcrit = 1.9 * c.RCLCRIT
        icrit = 0.0001
    else:
        lcrit = 2.0 * c.RCLCRIT
        icrit = 2.0 * c.RCLCRIT
    clc_safe = jnp.where(act, clc, 1.0)
    # one reciprocal of the cloud fraction serves both species' in-cloud
    # contents AND their perturbations (6 divides fold into 1; quotient
    # rule via the shared reciprocal: cldl_i = (qlwc_i - cldl*clc_i)/clc)
    rclc = 1.0 / clc_safe

    cldl = qlwc * rclc
    cldl_i = (qlwc_i - cldl * clc_i) * rclc
    ltmp4 = jnp.exp(-(cldl * cldl * (1.0 / (lcrit * lcrit))))
    dl = ckcodtl * (1.0 - ltmp4)
    ltmp5 = jnp.exp(-dl)
    lfactor = ckcodtla if c.LREGCL else ckcodtl  # reference :444-448
    dl_i = (2.0 * lfactor / lcrit**2.0) * ltmp4 * cldl * cldl_i
    qlnew = clc * cldl * ltmp5
    qlnew_i = clc_i * cldl * ltmp5 + clc * cldl_i * ltmp5 - clc * cldl * ltmp5 * dl_i
    act_ = fmask(act, clc) if ms else act
    prr = sel0(act_, qlwc - qlnew)
    prr_i = sel0(act_, qlwc_i - qlnew_i)
    qlwc = qlwc - prr
    qlwc_i = qlwc_i - prr_i

    cldi = qiwc * rclc
    cldi_i = (qiwc_i - cldi * clc_i) * rclc
    itmp41 = jnp.exp(-(cldi * cldi * (1.0 / (icrit * icrit))))

    pre = dict(
        t2=t, t2_i=t_i, q2=q, q2_i=q_i, ql_fg=ql, ql_fg_i=ql_i,
        qi_fg=qi, qi_fg_i=qi_i, dp=dp, dp_i=dp_i, gdp=gdp, gdp_i=gdp_i,
        lvdcp=lvdcp, lvdcp_i=lvdcp_i, lsdcp=lsdcp, lsdcp_i=lsdcp_i,
        fwat=fwat, fwat_i=fwat_i, clc=clc, clc_i=clc_i,
        condl1=condl, condl1_i=condl_i, condi1=condi, condi1_i=condi_i,
        qiwc1=qiwc, qiwc1_i=qiwc_i, prr=prr, prr_i=prr_i,
        cldi=cldi, cldi_i=cldi_i, itmp41=itmp41, act=act,
        rcons=rcons, rcons_i=rcons_i, z2s=z2s, z2s_i=z2s_i,
        lude_s=lude, lude_s_i=lude_i, qsat_sups=qsat, qsat_sups_i=qsat_i,
        tnd_ql=(qlwc - ql) * rdt, tnd_ql_i=(qlwc_i - ql_i) * rdt,
    )
    if c.LEVAPLS2 or c.LDRAIN1D:
        # carry-free factors of the precipitation evaporation
        # (reference :547, :584-588)
        pre["qlim"] = qlim
        pre["qlim_i"] = qlim_i
        pre["corqs"] = corqs
        pre["corqs_i"] = corqs_i
        pre["tmp6"] = jnp.sqrt(ap / aph_s)
        pre["dtgdp"] = dt * c.RG / dp
        pre["dtgdp_i"] = -dt * c.RG * dp_i / dp ** 2.0
    return pre


def tl_level_post(
    carry: TLCarry,
    xp: Dict[str, Array],
    aph_s: Array,
    aph_s_i: Array,
    dt: float,
    c: Constants,
) -> Tuple[TLCarry, Dict[str, Array]]:
    """Carry-dependent tail of one TL level (phase B).

    ``xp`` holds the raw level inputs merged with the
    :func:`tl_level_pre` values.  Covers maximum precipitation overlap,
    snow melt, the melt-temperature half of the ice autoconversion, rain
    fraction, the precipitation-evaporation branch, tendency assembly and
    the final clipping (reference ``tangent_linear/_stencils/cloudsc2.py:
    388-397, 413-427, 472-753``).
    """
    rfl, sfl, covptot, rfl_i, sfl_i, covptot_i = carry
    ckcodti = 5.0 * c.RKCONV * dt
    ckcodtia = ckcodti / 100.0
    cons2 = 1.0 / (c.RG * dt)
    rdt = 1.0 / dt
    icrit = 0.0001 if (c.LEVAPLS2 or c.LDRAIN1D) else 2.0 * c.RCLCRIT
    ap, ap_i = xp["ap"], xp["ap_i"]
    qsat_in, qsat_in_i = xp["qsat"], xp["qsat_i"]
    t, t_i = xp["t2"], xp["t2_i"]
    q, q_i = xp["q2"], xp["q2_i"]
    qi, qi_i = xp["qi_fg"], xp["qi_fg_i"]
    dp, dp_i = xp["dp"], xp["dp_i"]
    gdp, gdp_i = xp["gdp"], xp["gdp_i"]
    lvdcp, lvdcp_i = xp["lvdcp"], xp["lvdcp_i"]
    lsdcp, lsdcp_i = xp["lsdcp"], xp["lsdcp_i"]
    fwat, fwat_i = xp["fwat"], xp["fwat_i"]
    clc, clc_i = xp["clc"], xp["clc_i"]
    condl, condl_i = xp["condl1"], xp["condl1_i"]
    condi, condi_i = xp["condi1"], xp["condi1_i"]
    qiwc, qiwc_i = xp["qiwc1"], xp["qiwc1_i"]
    prr, prr_i = xp["prr"], xp["prr_i"]
    cldi, cldi_i = xp["cldi"], xp["cldi_i"]
    itmp41, act = xp["itmp41"], xp["act"]
    rcons, rcons_i = xp["rcons"], xp["rcons_i"]
    z2s, z2s_i = xp["z2s"], xp["z2s_i"]
    ms = c.MASK_SELECT
    # maximum precipitation overlap (reference :388-397); the value selects
    # are plain max forms (the NL shapes), the perturbation selects keep
    # their predicates
    grow = clc > covptot
    covptot = jnp.maximum(covptot, clc)
    covptot_i = jnp.where(grow, clc_i, covptot_i)
    covpclr1 = covptot - clc
    pos = covpclr1 >= 0.0
    covpclr = jnp.maximum(covpclr1, 0.0)
    covpclr_i = sel0(fmask(pos, covpclr1) if ms else pos, covptot_i - clc_i)

    # melting of incoming snow (reference :399-427).  The six selects on
    # ``melt`` share one gated increment pair: where(melt, x+y, x) ==
    # x + sel0(y); the snmlt value select is a plain min (the NL form)
    melt = sfl != 0.0
    take_sfl = sfl <= z2s
    snmlt = jnp.minimum(sfl, z2s)
    snmlt_i = jnp.where(take_sfl, sfl_i, z2s_i)
    melt_ = fmask(melt, sfl) if ms else melt
    sm = sel0(melt_, snmlt)
    smi = sel0(melt_, snmlt_i)
    rfln = rfl + sm
    rfln_i = rfl_i + smi
    sfln = sfl - sm
    sfln_i = sfl_i - smi
    # rcons = 1/cons exactly (dt*gdp*lfdcp, tl_level_pre), and rcons_i is
    # its exact derivative — the quotient-rule update becomes a product rule
    t_i = t_i - (smi * rcons + sm * rcons_i)
    t = t - sm * rcons

    # melt-temperature half of the ice autoconversion (reference :472-503)
    itmp42 = jnp.exp(0.025 * (t - c.RTT))
    di = ckcodti * itmp42 * (1.0 - itmp41)
    itmp5 = jnp.exp(-di)
    ifactor = ckcodtia if c.LREGCL else ckcodti  # reference :475-487
    di_i = ifactor * itmp42 * (
        itmp41 * (2.0 * cldi * cldi_i * (1.0 / icrit**2.0) - 0.025 * t_i) + 0.025 * t_i
    )
    qinew = clc * cldi * itmp5
    qinew_i = clc_i * cldi * itmp5 + clc * cldi_i * itmp5 - clc * cldi * itmp5 * di_i
    act_ = fmask(act, clc) if ms else act
    prs = sel0(act_, qiwc - qinew)
    prs_i = sel0(act_, qiwc_i - qinew_i)
    qiwc = qiwc - prs
    qiwc_i = qiwc_i - prs_i

    # new precipitation and rain fraction (reference :505-523)
    dr = cons2 * dp * (prr + prs)
    dr_i = cons2 * (dp_i * (prr + prs) + dp * (prr_i + prs_i))
    coldt = t < c.RTT
    coldt_ = fmask(coldt, t) if ms else coldt
    rfreeze = sel0(coldt_, cons2 * dp * prr)
    rfreeze_i = sel0(coldt_, cons2 * (dp_i * prr + dp * prr_i))
    fwatr = 1.0 - coldt_ if ms else jnp.where(coldt, 0.0, 1.0)
    rfln = rfln + fwatr * dr
    rfln_i = rfln_i + fwatr * dr_i
    sfln = sfln + (1.0 - fwatr) * dr
    sfln_i = sfln_i + (1.0 - fwatr) * dr_i

    # precipitation evaporation (reference :525-616); statically compiled out
    # in the default configuration
    prtot = rfln + sfln
    prtot_i = rfln_i + sfln_i
    if c.LEVAPLS2 or c.LDRAIN1D:
        eact = (prtot > c.ZEPS2) & (covpclr > c.ZEPS2)
        covptot_safe = jnp.where(eact, covptot, 1.0)
        covpclr_safe = jnp.where(eact, covpclr, 1.0)
        prtot_safe = jnp.where(eact, prtot, 1.0)
        preclr = prtot * covpclr / covptot_safe
        preclr_i = (
            ((prtot_i * covpclr + prtot * covpclr_i) / covptot_safe)
            - (prtot * covpclr * covptot_i / covptot_safe ** 2.0)
        )
        clcc = jnp.where(eact, 1.0 - clc, 1.0)
        qlim, qlim_i = xp["qlim"], xp["qlim_i"]
        corqs, corqs_i = xp["corqs"], xp["corqs_i"]
        qe = qsat_in - ((qsat_in - qlim) * covpclr / clcc ** 2.0)
        qe_i = (
            qsat_in_i
            - (
                (qsat_in_i * covpclr - qlim_i * covpclr + (qsat_in - qlim) * covpclr_i)
                / clcc ** 2.0
            )
            - (2.0 * (qsat_in - qlim) * covpclr * clc_i / clcc ** 3.0)
        )
        tmp6 = xp["tmp6"]
        preclr_safe = jnp.where(eact & (preclr > 0.0), preclr, 1.0)
        beta = c.RG * c.RPECONS * (tmp6 * preclr_safe / (0.00509 * covpclr_safe)) ** 0.5777
        beta_i = (
            0.5777
            * c.RG
            * c.RPECONS
            / 0.00509
            * (0.00509 * covpclr_safe / (tmp6 * preclr_safe)) ** 0.4223
            * (
                (
                    tmp6 * preclr_i
                    # exact derivative of tmp6 = sqrt(ap/aph_s):
                    # 0.5*tmp6*ap_i/ap = 0.5*ap_i/(tmp6*aph_s).  The
                    # reference TL writes 0.5*preclr*ap_i/tmp6
                    # (tangent_linear/_stencils/cloudsc2.py:567), which is
                    # aph_s times the true derivative — an apparent
                    # transcription slip in a branch the reference compiles
                    # out by default (LEVAPLS2=False) and never validates;
                    # we keep the exact form, pinned by the jax.jvp
                    # cross-check with LEVAPLS2=True.
                    + (0.5 * preclr_safe * ap_i / (tmp6 * aph_s))
                    - (0.5 * preclr_safe * tmp6 * aph_s_i / aph_s)
                )
                * (1.0 / covpclr_safe)
                - (tmp6 * preclr_safe * covpclr_i / covpclr_safe ** 2.0)
            )
        )
        b = dt * beta * (qsat_in - qe) / (1.0 + dt * beta * corqs)
        # quotient rule for b = u/v, u = dt*beta*(qsat-qe),
        # v = 1 + dt*beta*corqs: the second term is u*v_i/v^2 = dt*b*(...)/v.
        # The reference TL writes dt**2*b*(...)/v
        # (tangent_linear/_stencils/cloudsc2.py:579-581) — an extra factor of
        # dt (~600x) in a branch it compiles out by default; we keep the
        # exact derivative, pinned by the jax.jvp cross-check.
        b_i = (
            dt * (beta_i * (qsat_in - qe) + beta * (qsat_in_i - qe_i))
            / (1.0 + dt * beta * corqs)
        ) - (
            dt * b * (beta_i * corqs + beta * corqs_i) / (1.0 + dt * beta * corqs)
        )
        dtgdp = xp["dtgdp"]
        dtgdp_i = xp["dtgdp_i"]
        dpr = covpclr * b / dtgdp
        dpr_i = ((covpclr_i * b + covpclr * b_i) / dtgdp) - (covpclr * b * dtgdp_i / dtgdp ** 2.0)
        big = dpr > preclr
        dpr = jnp.where(big, preclr, dpr)
        dpr_i = jnp.where(big, preclr_i, dpr_i)
        dpr = jnp.where(eact, dpr, 0.0)
        dpr_i = jnp.where(eact, dpr_i, 0.0)
        preclr = preclr - dpr
        preclr_i = preclr_i - dpr_i
        drained = eact & (preclr <= 0.0)
        covptot = jnp.where(drained, clc, covptot)
        covptot_i = jnp.where(drained, clc_i, covptot_i)
        covptot_out = jnp.where(eact, covptot, 0.0)
        covptot_out_i = jnp.where(eact, covptot_i, 0.0)
        evapr = jnp.where(eact, dpr * rfln / prtot_safe, 0.0)
        evapr_i = jnp.where(
            eact,
            (dpr_i * rfln + dpr * rfln_i) / prtot_safe
            - dpr * rfln * prtot_i / prtot_safe ** 2.0,
            0.0,
        )
        rfln = rfln - evapr
        rfln_i = rfln_i - evapr_i
        evaps = jnp.where(eact, dpr * sfln / prtot_safe, 0.0)
        evaps_i = jnp.where(
            eact,
            (dpr_i * sfln + dpr * sfln_i) / prtot_safe
            - dpr * sfln * prtot_i / prtot_safe ** 2.0,
            0.0,
        )
        sfln = sfln - evaps
        sfln_i = sfln_i - evaps_i
    else:
        zero = jnp.zeros_like(prtot)
        evapr = evapr_i = evaps = evaps_i = zero
        covptot_out = covptot_out_i = zero

    # T and q increments (reference :618-659)
    dqdt = -(condl + condi) + (xp["lude"] + evapr + evaps) * gdp
    dqdt_i = (
        -(condl_i + condi_i)
        + (xp["lude_i"] + evapr_i + evaps_i) * gdp
        + (xp["lude"] + evapr + evaps) * gdp_i
    )
    tmp7 = (
        lvdcp * evapr
        + lsdcp * evaps
        + xp["lude"] * (fwat * lvdcp + (1.0 - fwat) * lsdcp)
        - (lsdcp - lvdcp) * rfreeze
    )
    dtdt = lvdcp * condl + lsdcp * condi - tmp7 * gdp
    dtdt_i = (
        lvdcp_i * condl
        + lvdcp * condl_i
        + lsdcp_i * condi
        + lsdcp * condi_i
        - (
            lvdcp_i * evapr
            + lvdcp * evapr_i
            + lsdcp_i * evaps
            + lsdcp * evaps_i
            + xp["lude_i"] * (fwat * lvdcp + (1.0 - fwat) * lsdcp)
            + xp["lude"] * (fwat_i * (lvdcp - lsdcp) + fwat * lvdcp_i + (1.0 - fwat) * lsdcp_i)
            - (lsdcp_i - lvdcp_i) * rfreeze
            - (lsdcp - lvdcp) * rfreeze_i
        )
        * gdp
        - tmp7 * gdp_i
    )
    t = t + dt * dtdt
    t_i = t_i + dt * dtdt_i
    q = q + dt * dqdt
    q_i = q_i + dt * dqdt_i
    qold = q
    qold_i = q_i

    # clipping of final qv (reference :661-673)
    t, t_i, q, q_i = cuadjtqs_tl(ap, ap_i, t, t_i, q, q_i, c)
    # qold >= q iff qold - q >= 0 (IEEE subtraction preserves sign): the
    # guarded difference is a single max; the gated dq_i is zero on the
    # unclipped branch already, so the LREGCL damping needs no select
    clipped = qold >= q
    dq = jnp.maximum(qold - q, 0.0)
    dq_i = sel0(fmask(clipped, q) if ms else clipped, qold_i - q_i)
    if c.LREGCL:
        dq_i = dq_i * 0.7  # reference :667-668
    dr2 = cons2 * dp * dq
    dr2_i = cons2 * (dp_i * dq + dp * dq_i)

    # update rain fraction and freezing (reference :675-703)
    coldt2 = t < c.RTT
    coldt2_ = fmask(coldt2, t) if ms else coldt2
    rfreeze2 = sel0(coldt2_, fwat * dr2)
    rfreeze2_i = sel0(coldt2_, fwat_i * dr2 + fwat * dr2_i)
    fwatr2 = 1.0 - coldt2_ if ms else jnp.where(coldt2, 0.0, 1.0)
    rn = fwatr2 * dr2
    rn_i = fwatr2 * dr2_i
    sn = (1.0 - fwatr2) * dr2
    sn_i = (1.0 - fwatr2) * dr2_i
    condl = condl + fwatr2 * dq * rdt
    condl_i = condl_i + fwatr2 * dq_i * rdt
    condi = condi + (1.0 - fwatr2) * dq * rdt
    condi_i = condi_i + (1.0 - fwatr2) * dq_i * rdt
    rfln = rfln + rn
    rfln_i = rfln_i + rn_i
    sfln = sfln + sn
    sfln_i = sfln_i + sn_i
    rfreeze = rfreeze + rfreeze2
    rfreeze_i = rfreeze_i + rfreeze2_i

    # output tendencies (reference :705-741)
    tnd_q = -(condl + condi) + (xp["lude"] + evapr + evaps) * gdp
    tnd_q_i = (
        -(condl_i + condi_i)
        + (xp["lude_i"] + evapr_i + evaps_i) * gdp
        + (xp["lude"] + evapr + evaps) * gdp_i
    )
    tmp8 = (
        lvdcp * evapr
        + lsdcp * evaps
        + xp["lude"] * (fwat * lvdcp + (1.0 - fwat) * lsdcp)
        - (lsdcp - lvdcp) * rfreeze
    )
    tnd_t = lvdcp * condl + lsdcp * condi - tmp8 * gdp
    tnd_t_i = (
        lvdcp_i * condl
        + lvdcp * condl_i
        + lsdcp_i * condi
        + lsdcp * condi_i
        - (
            lvdcp_i * evapr
            + lvdcp * evapr_i
            + lsdcp_i * evaps
            + lsdcp * evaps_i
            + xp["lude_i"] * (fwat * lvdcp + (1.0 - fwat) * lsdcp)
            + xp["lude"] * (fwat_i * (lvdcp - lsdcp) + fwat * lvdcp_i + (1.0 - fwat) * lsdcp_i)
            - (lsdcp_i - lvdcp_i) * rfreeze
            - (lsdcp - lvdcp) * rfreeze_i
        )
        * gdp
        - tmp8 * gdp_i
    )

    outs = {
        "tnd_t": tnd_t,
        "tnd_t_i": tnd_t_i,
        "tnd_q": tnd_q,
        "tnd_q_i": tnd_q_i,
        "tnd_ql": xp["tnd_ql"],
        "tnd_ql_i": xp["tnd_ql_i"],
        "tnd_qi": (qiwc - qi) * rdt,
        "tnd_qi_i": (qiwc_i - qi_i) * rdt,
        "clc": clc,
        "clc_i": clc_i,
        "covptot": covptot_out,
        "covptot_i": covptot_out_i,
        "fplsl": rfln,
        "fplsl_i": rfln_i,
        "fplsn": sfln,
        "fplsn_i": sfln_i,
    }
    return TLCarry(rfln, sfln, covptot, rfln_i, sfln_i, covptot_i), outs




def tl_level(
    carry: TLCarry,
    x: Dict[str, Array],
    aph_s: Array,
    aph_s_i: Array,
    trpaus: Array,
    dt: float,
    c: Constants,
) -> Tuple[TLCarry, Dict[str, Array]]:
    """One vertical level of the tangent-linear scheme (reference :149-753).

    Composed from the carry-independent :func:`tl_level_pre` (phase A) and
    the carry-dependent :func:`tl_level_post` (phase B) — a pure statement
    reordering of the hand-derived TL level body.
    """
    pre = tl_level_pre(x, aph_s, trpaus, dt, c)
    return tl_level_post(carry, {**x, **pre}, aph_s, aph_s_i, dt, c)


def prepare_tl_level_inputs(state: Dict[str, Array], dt: float, c: Constants) -> Dict[str, Array]:
    """Per-level scan inputs including the perturbation fields."""
    xs = prepare_level_inputs(state, dt, c)
    lu_i = state["lu_i"]
    xs.update(
        ap_i=state["ap_i"],
        aph0_i=state["aph_i"][:-1],
        aph1_i=state["aph_i"][1:],
        lu_next_i=jnp.concatenate([lu_i[1:], jnp.zeros_like(lu_i[:1])], axis=0),
        lude_i=state["lude_i"],
        mfd_i=state["mfd_i"],
        mfu_i=state["mfu_i"],
        q_i=state["q_i"],
        qi_i=state["qi_i"],
        ql_i=state["ql_i"],
        qsat_i=state["qsat_i"],
        supsat_i=state["supsat_i"],
        t_i=state["t_i"],
        tnd_cml_q_i=state["tnd_cml_q_i"],
        tnd_cml_qi_i=state["tnd_cml_qi_i"],
        tnd_cml_ql_i=state["tnd_cml_ql_i"],
        tnd_cml_t_i=state["tnd_cml_t_i"],
    )
    return xs


@partial(jax.jit, static_argnames=("c", "remat"))
def cloudsc2_tl(
    state: Dict[str, Array], dt: float, c: Constants, remat: bool = False
) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Run the tangent-linear CLOUDSC2 scheme over all levels.

    ``state`` must contain the 16 input fields AND their 16 perturbations
    (suffix ``_i``), plus ``eta`` and ``qsat``/``qsat_i``.  Returns
    ``(tendencies, diagnostics)`` with forward and perturbation fields, the
    same 8 + 12 outputs as the reference component
    (``tangent_linear/microphysics.py:132-160``).

    ``remat`` wraps the per-level body in :func:`jax.checkpoint` so that a
    reverse-mode transpose of this scan (the adjoint,
    :mod:`cloudsc2_tpu.physics.adjoint`) stores only the tiny carried state
    per level and regenerates all intermediates during the reverse sweep —
    the analogue of the reference adjoint's forward-recompute strategy
    (``adjoint/_stencils/cloudsc2.py:133-476``).
    """
    xs = prepare_tl_level_inputs(state, dt, c)
    ncols = state["ap"].shape[1]
    dtype = state["ap"].dtype
    trpaus = tropopause_eta(state["eta"].astype(dtype), xs["t_fg"])
    aph_s = state["aph"][-1]
    aph_s_i = state["aph_i"][-1]

    def body(carry: TLCarry, x: Dict[str, Array]):
        return tl_level(carry, x, aph_s, aph_s_i, trpaus, dt, c)

    if remat:
        body = jax.checkpoint(body, policy=jax.checkpoint_policies.nothing_saveable)

    z = jnp.zeros((ncols,), dtype)
    _, ys = jax.lax.scan(body, TLCarry(z, z, z, z, z, z), xs)

    zrow = jnp.zeros((1, ncols), dtype)
    out: Dict[str, Dict[str, Array]] = {"tends": {}, "diags": {}}
    for name in ("t", "q", "ql", "qi"):
        out["tends"][name] = ys["tnd_" + name]
        out["tends"][name + "_i"] = ys["tnd_" + name + "_i"]
    for name in ("clc", "clc_i", "covptot", "covptot_i"):
        out["diags"][name] = ys[name]
    for name in ("fplsl", "fplsl_i", "fplsn", "fplsn_i"):
        out["diags"][name] = jnp.concatenate([zrow, ys[name]], axis=0)
    out["diags"]["fhpsl"] = -out["diags"]["fplsl"] * c.RLVTT
    out["diags"]["fhpsl_i"] = -out["diags"]["fplsl_i"] * c.RLVTT
    out["diags"]["fhpsn"] = -out["diags"]["fplsn"] * c.RLSTT
    out["diags"]["fhpsn_i"] = -out["diags"]["fplsn_i"] * c.RLSTT
    return out["tends"], out["diags"]
