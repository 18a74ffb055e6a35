
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLOUDSC2 nonlinear scheme, JAX formulation.

JAX re-implementation of the reference ``cloudsc2_nl`` gtscript stencil
(``src/cloudsc2_gt4py/physics/nonlinear/_stencils/cloudsc2.py:24-399``) and
its component wrapper (``physics/nonlinear/microphysics.py:43-172``).

Design (a re-implementation, not a translation):

* Arrays are laid out ``(nlev, ncols)`` — columns on the fast axis,
  levels on the scan dimension.  The dummy ``J`` axis of the reference is
  dropped.
* The strict top-down recurrence of the scheme (rain/snow fluxes, maximum
  precipitation overlap, melted snow feeding the next level) is expressed as
  a ``jax.lax.scan`` over levels with a small carried state
  ``(rfl, sfl, covptot)`` — the analogue of the reference's 2-D ``tmp_*``
  fields (``microphysics.py:131-133``).
* Per-column branches become ``jnp.where`` selections with guarded operands
  (safe denominators / sqrt arguments) so that no lane ever produces NaN and
  ``jax.jvp`` / ``jax.vjp`` of this function remain well defined.
* All physics constants are static Python scalars
  (:class:`cloudsc2_tpu.params.Constants`) closed over at trace time — the
  XLA analogue of GT4Py compile-time externals.

The per-level body :func:`nl_level` additionally returns the full set of
intermediate quantities (``aux``).  The hand-written adjoint
(:mod:`cloudsc2_tpu.physics.adjoint`) re-invokes the body during its reverse
sweep to regenerate the trajectory from the tiny carried state, instead of
materializing ~35 full 3-D temporaries the way the reference does
(``physics/adjoint/_stencils/cloudsc2.py:133-476``) — an O(nlev) memory
saving that keeps the reverse pass HBM-light.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics import fcttre
from cloudsc2_tpu.physics.fastmath import fmask, sel0
from cloudsc2_tpu.physics.cuadjtqs import cuadjtqs_nl

Array = jnp.ndarray


class NLCarry(NamedTuple):
    """State carried down the vertical scan (reference ``tmp_*`` IJ fields)."""

    rfl: Array  # rain flux entering the level from above
    sfl: Array  # snow flux entering the level from above
    covptot: Array  # running maximum-overlap precipitation cover


def tropopause_eta(eta: Array, t_fg: Array) -> Array:
    """Tropopause eta per column (reference ``cloudsc2.py:106-111``).

    Forward-scan semantics: the *last* level ``k`` (largest eta) with
    ``0.1 < eta[k] < 0.4`` and ``t[k] > t[k+1]`` wins; default 0.1.
    """
    nlev = eta.shape[0]
    window = (eta[:-1] > 0.1) & (eta[:-1] < 0.4)  # (nlev-1,)
    mask = window[:, None] & (t_fg[:-1] > t_fg[1:])  # (nlev-1, ncols)
    ks = jnp.arange(nlev - 1, dtype=jnp.int32)[:, None]
    best = jnp.max(jnp.where(mask, ks, -1), axis=0)  # (ncols,)
    return jnp.where(best >= 0, eta[jnp.maximum(best, 0)], jnp.asarray(0.1, eta.dtype))


def scalm_profile(eta: Array, c: Constants) -> Array:
    """The scheme's vertical scaling profile ZSCAL*max(eta-0.2, ZEPS1)**0.2
    (reference ``cloudsc2.py:163``) — one definition shared by the scan path
    and the kernel wrappers so a Constants override is honored
    everywhere."""
    return jnp.asarray(c.ZSCAL, eta.dtype) * jnp.maximum(eta - 0.2, c.ZEPS1) ** 0.2


def critical_rh_coeffs(trpaus: Array) -> Tuple[Array, Array, Array]:
    """Per-column coefficients of the critical-RH profile — a pure function
    of the tropopause eta, hoisted out of the level loop (the reference
    recomputes them at every level, ``cloudsc2.py:168-171``).  The third
    coefficient is ``rsqrt(deta1)``, hoisting the boundary-layer branch's
    per-level divide+sqrt (``sqrt((1-eta)/deta1)`` factors into
    ``sqrt(1-eta) * rsqrt(deta1)``; ``eta <= 1`` always)."""
    rh2 = (
        0.35
        + 0.14 * ((trpaus - 0.25) / 0.15) ** 2.0
        + 0.04 * jnp.minimum(trpaus - 0.25, 0.0) / 0.15
    )
    deta1 = 0.09 + 0.16 * (0.4 - trpaus) / 0.3
    return rh2, deta1, jax.lax.rsqrt(deta1)


def critical_rh(
    eta_k: Array, trpaus: Array, coeffs: Tuple[Array, ...] | None = None
) -> Array:
    """Critical relative-humidity profile (reference ``cloudsc2.py:166-186``)."""
    rh2, deta1, rsq_deta1 = critical_rh_coeffs(trpaus) if coeffs is None else coeffs
    rh1 = 1.0
    rh3 = 1.0
    rdeta2 = 1.0 / 0.3  # deta2 = 0.3, static
    sq = jnp.sqrt(jnp.maximum(1.0 - eta_k, 0.0)) * rsq_deta1
    return jnp.where(
        eta_k < trpaus,
        rh3,
        jnp.where(
            eta_k < trpaus + 0.3,
            rh3 + (rh2 - rh3) * ((eta_k - trpaus) * rdeta2),
            jnp.where(eta_k < 1.0 - deta1, rh2, rh1 + (rh2 - rh1) * sq),
        ),
    )


def nl_level_pre(
    x: Dict[str, Array],
    aph_s: Array,
    trpaus: Array,
    dt: float,
    c: Constants,
) -> Dict[str, Any]:
    """Carry-independent portion of one vertical level (phase A).

    Everything in the reference level body that does not read the
    ``(rfl, sfl, covptot)`` recurrence: first guess, thermodynamic
    coefficients, dqs/dT, critical humidity, Letreut--Li cloud cover,
    detrainment, compensating subsidence, condensation rates, the melt
    constants, and the carry-free half of the autoconversion
    (reference ``cloudsc2.py:102-230, 237-241, 248-263``).

    Keys that would shadow a raw level input are suffixed (``lude_s``,
    ``ql_fg``, ``qi_fg``, ``qsat_sups``) so the dict can be merged into
    ``x`` for :func:`nl_level_post`.
    """
    ap = x["ap"]
    rap = 1.0 / ap
    qsat_in = x["qsat"]
    pre: Dict[str, Any] = {"rap": rap}

    # first-guess state (reference :102-104, :113-117).  The raw species /
    # accumulated tendencies / supsat enter the scheme ONLY through these
    # combines, so the kernel wrappers stream the precomputed first-guess
    # values (3 streams instead of 7); the combine is bit-identical
    t = x["t_fg"]
    q = x["q2"] if "q2" in x else x["q"] + dt * x["tnd_cml_q"] + x["supsat"]
    ql = x["ql_fg"] if "ql_fg" in x else x["ql"] + dt * x["tnd_cml_ql"]
    qi = x["qi_fg"] if "qi_fg" in x else x["qi"] + dt * x["tnd_cml_qi"]
    pre.update(t2=t, q2=q, ql_fg=ql, qi_fg=qi)

    # constants (reference :119-127)
    ckcodtl = 2.0 * c.RKCONV * dt
    cons2 = 1.0 / (c.RG * dt)
    cons3 = c.RLVTT / c.RCPD
    scalm = x["scalm"]

    # thermodynamic coefficients (reference :129-134); one reciprocal of the
    # moist heat capacity instead of three divides.  The interface
    # pressures enter the scheme ONLY through their difference, so the
    # kernel wrappers stream precomputed ``dp`` (one HBM stream instead of
    # two near-identical aph slices); the subtract here is bit-identical
    dp = x["dp"] if "dp" in x else x["aph1"] - x["aph0"]
    zz = c.RCPD + c.RCPD * c.RVTMP2 * q
    rzz = 1.0 / zz
    lfdcp = c.RLMLT * rzz
    lsdcp = c.RLSTT * rzz
    lvdcp = c.RLVTT * rzz
    pre.update(dp=dp, zz=zz, lfdcp=lfdcp, lsdcp=lsdcp, lvdcp=lvdcp)

    # dqs/dT correction factor (reference :140-160); LPHYLIN/LDRAIN1D static.
    # One reciprocal each of (t - R4LES) and (t - R4IES) serves the
    # saturation-pressure exponent argument AND the two dqs/dT factors
    # (facw = R5LES/(t-R4LES)^2 = R5LES*rl*rl), replacing three divides.
    rl = 1.0 / (t - c.R4LES)
    ri = 1.0 / (t - c.R4IES)
    if c.LPHYLIN or c.LDRAIN1D:
        cold = t < c.RTT
        fwat = jnp.where(cold, 0.545 * (jnp.tanh(0.17 * (t - c.RLPTRC)) + 1.0), 1.0)
        z3es = jnp.where(cold, c.R3IES, c.R3LES)
        rz4es = jnp.where(cold, ri, rl)
        foeew = c.R2ES * jnp.exp(z3es * (t - c.RTT) * rz4es)
        esdp1 = foeew * rap
        esdp = jnp.minimum(esdp1, c.ZQMAX)
    else:
        fwat = fcttre.foealfa(t, c)
        foeew = fcttre.foeewm(t, c)
        esdp1 = foeew * rap
        esdp = esdp1
    facw = c.R5LES * rl * rl
    faci = c.R5IES * ri * ri
    fac = fwat * facw + (1.0 - fwat) * faci
    # cor = 1/(1 - RETV*esdp): in the unclipped regime this equals
    # ap * fac2 with fac2 = 1/(ap - RETV*foeew) — the reciprocal the
    # subsidence section needs anyway (reference :219) — so the clip case
    # reduces to a compile-time constant and one divide disappears
    fac2 = 1.0 / (ap - c.RETV * foeew)
    cor_unclipped = ap * fac2
    if c.LPHYLIN or c.LDRAIN1D:
        cor = jnp.where(
            esdp1 <= c.ZQMAX, cor_unclipped, 1.0 / (1.0 - c.RETV * c.ZQMAX)
        )
    else:
        cor = cor_unclipped
    dqsdtemp = fac * cor * qsat_in
    corqs = 1.0 + cons3 * dqsdtemp
    pre.update(
        fwat=fwat, foeew=foeew, esdp1=esdp1, esdp=esdp, facw=facw, faci=faci,
        fac=fac, cor=cor, dqsdtemp=dqsdtemp, corqs=corqs,
    )

    # clipped state (reference :163)
    qlim = jnp.minimum(q, qsat_in)
    pre["qlim"] = qlim

    # critical humidity and ice supersaturation (reference :166-193);
    # per-column coefficients may arrive precomputed (the kernel path
    # hoists them out of the level loop via the kernel's col inputs)
    coeffs = (
        (x["crh_rh2"], x["crh_deta1"], x["crh_rsq"]) if "crh_rh2" in x else None
    )
    crh2 = critical_rh(x["eta"], trpaus, coeffs)
    supsat_fac = jnp.where(t < c.RTICE, 1.8 - 0.003 * t, 1.0)
    qsat = qsat_in * supsat_fac
    qcrit = crh2 * qsat
    pre.update(crh2=crh2, supsat_fac=supsat_fac, qsat_sups=qsat, qcrit=qcrit)

    # Letreut & Li (1990) uniform-distribution cloud cover (reference :195-207)
    ms = c.MASK_SELECT
    qt = q + ql + qi
    low = qt < qcrit
    high = qt >= qsat
    mid = jnp.logical_not(low | high)
    qpd = qsat - qt
    qcd = qsat - qcrit
    denom = qcd - scalm * (qt - qcrit)
    denom_safe = jnp.where(mid, denom, 1.0)
    # ratio <= 1 holds in real arithmetic ((1-scalm)*(qt-qcrit) >= 0 in the
    # mid regime) but not under rounding — a divide/reciprocal ulp can push
    # it past 1 and drive clc = 1 - sqrt(ratio) negative; clamp to keep the
    # clc \in [0, 1] invariant under every divide strategy
    mid_ = fmask(mid, qpd) if ms else mid
    ratio = jnp.minimum(sel0(mid_, qpd / denom_safe), 1.0)
    tmp3 = jnp.sqrt(ratio)
    clc_mid = 1.0 - tmp3
    qc_mid = (scalm * qpd + (1.0 - scalm) * qcd) * clc_mid**2.0
    qc_high = (1.0 - scalm) * (qsat - qcrit)
    if ms:
        # exclusive regime masks: exactly one of (low, high, mid) holds per
        # lane, so the nested selects become sums of masked products —
        # bit-identical (each product is finite, one mask is 1)
        high_ = fmask(high, qpd)
        clc = high_ + mid_ * clc_mid
        qc = high_ * qc_high + mid_ * qc_mid
    else:
        clc = jnp.where(low, 0.0, jnp.where(high, 1.0, clc_mid))
        qc = jnp.where(low, 0.0, jnp.where(high, qc_high, qc_mid))
    pre.update(
        qt=qt, low=low, high=high, mid=mid, qpd=qpd, qcd=qcd,
        denom_safe=denom_safe, tmp3=tmp3, clc1=clc, qc1=qc,
    )

    # convective detrainment (reference :209-215)
    gdp = c.RG / dp
    lude = dt * x["lude"] * gdp
    lu1 = x["lu_next"]
    lo1 = (lude >= c.RLMIN) & (lu1 >= c.ZEPS2)
    lo1_ = fmask(lo1, lude) if ms else lo1
    lu1_safe = jnp.where(lo1, lu1, 1.0)
    tmp2 = jnp.exp(-lude / lu1_safe)
    clc = clc + sel0(lo1_, (1.0 - clc) * (1.0 - tmp2))
    qc = qc + sel0(lo1_, lude)
    pre.update(gdp=gdp, lude_s=lude, lo1=lo1, lu1_safe=lu1_safe, tmp2=tmp2, clc=clc, qc2=qc)

    # compensating subsidence (reference :217-224); fac4 = 1/rho = RD*t/ap
    # computed without a third divide; fac2 was already formed for cor above
    fac1 = 1.0 / (c.RD * t)
    rho = ap * fac1
    rodqsdp = -rho * qsat_in * fac2
    ldcp = fwat * lvdcp + (1.0 - fwat) * lsdcp
    fac3 = 1.0 / (1.0 + ldcp * dqsdtemp)
    dtdzmo = c.RG * (1.0 / c.RCPD - ldcp * rodqsdp) * fac3
    dqsdz = dqsdtemp * dtdzmo - c.RG * rodqsdp
    fac4 = c.RD * t * rap
    # the convective mass fluxes enter the scheme ONLY through their sum
    # (reference :217-224): the kernel wrappers stream one precomputed
    # ``mf`` (bit-identical add) instead of the two raw fields
    mf = x["mf"] if "mf" in x else x["mfu"] + x["mfd"]
    sub = dt * dqsdz * mf * fac4
    lo3 = sub < qc
    dqc = jnp.where(lo3, sub, qc)
    # qc - dqc == where(lo3, qc - sub, 0): one masked subtract; the dqc
    # select above survives only for aux (dead code in the kernels)
    qc = sel0(fmask(lo3, qc) if ms else lo3, qc - sub)
    pre.update(
        fac1=fac1, rho=rho, fac2=fac2, rodqsdp=rodqsdp, ldcp=ldcp, fac3=fac3,
        dtdzmo=dtdzmo, dqsdz=dqsdz, fac4=fac4, lo3=lo3, dqc=dqc, qc3=qc,
    )

    # new condensate and condensation rates (reference :226-230)
    qlwc = qc * fwat
    qiwc = qc * (1.0 - fwat)
    rdt = 1.0 / dt  # dt is static: the reciprocal is a compile-time constant
    condl = (qlwc - ql) * rdt
    condi = (qiwc - qi) * rdt
    pre.update(qlwc1=qlwc, qiwc1=qiwc, condl1=condl, condi1=condi)

    # melt constants (reference :237-241; the min() against the snow-flux
    # carry stays in phase B).  Both divides fold into multiplies:
    # cons = cons2*dp/lfdcp = (cons2/RLMLT)*dp*zz (lfdcp is RLMLT/zz), and
    # 1/cons = dt*gdp*lfdcp (cons2 = 1/(RG*dt), gdp = RG/dp)
    meltp2 = c.RTT + 2.0
    cons = (cons2 / c.RLMLT) * dp * zz
    rcons = dt * gdp * lfdcp
    z2s = cons * jnp.maximum(t - meltp2, 0.0)
    pre.update(cons=cons, rcons=rcons, z2s=z2s)

    # carry-free half of the rain / snow autoconversion (reference
    # :248-263): the liquid species does not see the melt-adjusted
    # temperature at all, and the ice species' cloud water and first
    # exponential do not either
    act = clc > c.ZEPS2
    if c.LEVAPLS2 or c.LDRAIN1D:
        lcrit = 1.9 * c.RCLCRIT
        icrit = 0.0001
    else:
        lcrit = 2.0 * c.RCLCRIT
        icrit = 2.0 * c.RCLCRIT
    # one reciprocal of the cloud fraction serves both species, and the
    # static crit thresholds divide at compile time
    act_ = fmask(act, clc) if ms else act
    clc_safe = jnp.where(act, clc, 1.0)
    rclc = 1.0 / clc_safe
    cldl = qlwc * rclc
    ltmp1 = jnp.exp(-(cldl * cldl * (1.0 / (lcrit * lcrit))))
    dl = ckcodtl * (1.0 - ltmp1)
    ltmp2 = jnp.exp(-dl)
    qlnew = clc * cldl * ltmp2
    # qlnew <= qlwc in real arithmetic (clc*cldl == qlwc, ltmp2 <= 1), but
    # clc*(qlwc/clc) rounds past qlwc when ltmp2 ~ 1; clamp so the rain
    # increment — and hence the accumulated fplsl flux — stays >= 0 under
    # every divide strategy
    prr = sel0(act_, jnp.maximum(qlwc - qlnew, 0.0))
    qlwc = qlwc - prr
    cldi = qiwc * rclc
    itmp11 = jnp.exp(-(cldi * cldi * (1.0 / (icrit * icrit))))
    pre.update(
        act=act, clc_safe=clc_safe, cldl=cldl, ltmp1=ltmp1, ltmp2=ltmp2,
        cldi=cldi, itmp11=itmp11, qlwc=qlwc, prr=prr,
    )

    # liquid-water tendency: fully determined by phase A (reference :376)
    pre["tnd_ql"] = (qlwc - ql) * rdt

    if c.LEVAPLS2 or c.LDRAIN1D:
        # carry-free factors of the precipitation evaporation (reference
        # :295, :305)
        pre["sqr"] = jnp.sqrt(ap / aph_s)
        pre["dtgdp"] = dt * c.RG / dp
    return pre


def nl_level_post(
    carry: NLCarry, xp: Dict[str, Array], dt: float, c: Constants
) -> Tuple[NLCarry, Dict[str, Array], Dict[str, Array]]:
    """Carry-dependent tail of one vertical level (phase B).

    ``xp`` holds the raw level inputs of :func:`nl_level` merged with the
    :func:`nl_level_pre` values.  Covers maximum precipitation overlap,
    snow melt, the melt-temperature half of the autoconversion, the
    precipitation-evaporation branch, tendency assembly and the
    saturation-adjustment clipping (reference ``cloudsc2.py:232-246,
    264-399``).

    """
    rfl, sfl, covptot = carry
    ms = c.MASK_SELECT
    cons2 = 1.0 / (c.RG * dt)
    ckcodti = 5.0 * c.RKCONV * dt
    rdt = 1.0 / dt
    aux: Dict[str, Array] = {}

    t = xp["t2"]
    clc = xp["clc"]
    gdp = xp["gdp"]
    dp = xp["dp"]
    fwat = xp["fwat"]
    lvdcp, lsdcp = xp["lvdcp"], xp["lsdcp"]
    rcons = xp["rcons"]
    condl, condi = xp["condl1"], xp["condi1"]
    qiwc = xp["qiwc1"]
    prr = xp["prr"]
    act = xp["act"]

    # maximum precipitation overlap (reference :232-235)
    covptot_in = covptot
    covptot = jnp.maximum(covptot_in, clc)
    covpclr1 = covptot - clc
    covpclr = jnp.maximum(covpclr1, 0.0)
    aux.update(covptot_in=covptot_in, covptot1=covptot, covpclr1=covpclr1, covpclr=covpclr)

    # melting of incoming snow (reference :237-246).  The three selects on
    # ``melt`` share one gated increment: where(melt, x+y, x) == x + sel0(y)
    melt = sfl != 0.0
    snmlt = jnp.minimum(sfl, xp["z2s"])
    sm = sel0(fmask(melt, sfl) if ms else melt, snmlt)
    rfln = rfl + sm
    sfln = sfl - sm
    t = t - sm * rcons
    aux.update(melt=melt, snmlt=snmlt, t_melt=t)

    # melt-temperature half of the snow autoconversion (reference :264-272)
    itmp11 = xp["itmp11"]
    itmp12 = jnp.exp(0.025 * (t - c.RTT))
    di = ckcodti * itmp12 * (1.0 - itmp11)
    itmp2 = jnp.exp(-di)
    qinew = clc * xp["cldi"] * itmp2
    act_ = fmask(act, clc) if ms else act
    prs = sel0(act_, jnp.maximum(qiwc - qinew, 0.0))
    qiwc = qiwc - prs
    aux.update(itmp12=itmp12, itmp2=itmp2, qiwc=qiwc, prs=prs)

    # new precipitation and rain fraction (reference :274-285)
    dr1 = cons2 * dp * (prr + prs)
    coldt = t < c.RTT
    coldt_ = fmask(coldt, t) if ms else coldt
    rfreeze = sel0(coldt_, cons2 * dp * prr)
    fwatr1 = 1.0 - coldt_ if ms else jnp.where(coldt, 0.0, 1.0)
    rfln = rfln + fwatr1 * dr1
    sfln = sfln + (1.0 - fwatr1) * dr1
    aux.update(dr1=dr1, coldt=coldt, rfreeze1=rfreeze, fwatr1=fwatr1, rfln2=rfln, sfln2=sfln)

    # precipitation evaporation (reference :287-321); statically compiled out
    # in the default configuration, exactly as with GT4Py externals
    prtot = rfln + sfln
    aux["prtot"] = prtot
    if c.LEVAPLS2 or c.LDRAIN1D:
        qsat_in = xp["qsat"]
        qlim = xp["qlim"]
        eact = (prtot > c.ZEPS2) & (covpclr > c.ZEPS2)
        covptot_safe = jnp.where(eact, covptot, 1.0)
        covpclr_safe = jnp.where(eact, covpclr, 1.0)
        preclr1 = prtot * covpclr / covptot_safe
        clcc = jnp.where(eact, 1.0 - clc, 1.0)
        qe = qsat_in - ((qsat_in - qlim) * covpclr / clcc ** 2.0)
        sqr = xp["sqr"]
        barg = jnp.where(eact, sqr / 0.00509 * preclr1 / covpclr_safe, 1.0)
        beta = c.RG * c.RPECONS * barg**0.5777
        b = dt * beta * (qsat_in - qe) / (1.0 + dt * beta * xp["corqs"])
        dtgdp = xp["dtgdp"]
        dpr1 = covpclr * b / dtgdp
        dpr = jnp.where(eact, jnp.minimum(dpr1, preclr1), 0.0)
        preclr = preclr1 - dpr
        covptot = jnp.where(eact & (preclr <= 0.0), clc, covptot)
        covptot_out = jnp.where(eact, covptot, 0.0)
        prtot_safe = jnp.where(eact, prtot, 1.0)
        evapr = jnp.where(eact, dpr * rfln / prtot_safe, 0.0)
        evaps = jnp.where(eact, dpr * sfln / prtot_safe, 0.0)
        rfln = rfln - evapr
        sfln = sfln - evaps
        aux.update(
            eact=eact, preclr1=preclr1, qe=qe, beta=beta, b=b, dtgdp=dtgdp,
            dpr1=dpr1, dpr=dpr, preclr=preclr, sqr=sqr, barg=barg,
            covptot_safe=covptot_safe, covpclr_safe=covpclr_safe,
            clcc=clcc, prtot_safe=prtot_safe,
        )
    else:
        zero = jnp.zeros_like(prtot)
        evapr = zero
        evaps = zero
        covptot_out = zero
    aux.update(evapr=evapr, evaps=evaps, covptot_out=covptot_out, covptot=covptot)

    # T / q tendency update and first guess (reference :323-344)
    dqdt = -(condl + condi) + (xp["lude"] + evapr + evaps) * gdp
    tmp7 = (
        lvdcp * evapr
        + lsdcp * evaps
        + xp["lude"] * (fwat * lvdcp + (1.0 - fwat) * lsdcp)
        - (lsdcp - lvdcp) * rfreeze
    )
    dtdt = lvdcp * condl + lsdcp * condi - tmp7 * gdp
    t3 = t + dt * dtdt
    q = xp["q2"] + dt * dqdt
    qold1 = q
    aux.update(dqdt=dqdt, dtdt=dtdt, t3=t3, qold1=qold1)

    # saturation-adjustment clipping (reference :347)
    t, q = cuadjtqs_nl(xp["ap"], t3, q, c, rap=xp["rap"])
    aux.update(t_adj=t, q_adj=q)

    # post-clipping rain fraction and freezing (reference :349-364).
    # Branch on the adjusted temperature, as in the NL (:352) and TL (:677)
    # stencils.  (The reference AD forward recompute branches on the
    # pre-adjustment t3 at adjoint/_stencils/cloudsc2.py:427 instead; we keep
    # the NL/TL convention so the adjoint is the exact transpose of the TL.)
    # qold1 >= q iff qold1 - q >= 0 (IEEE subtraction preserves sign), so
    # the guarded difference is a single max
    dq = jnp.maximum(qold1 - q, 0.0)
    dr2 = cons2 * dp * dq
    coldt2 = t < c.RTT
    coldt2_ = fmask(coldt2, t) if ms else coldt2
    rfreeze2 = sel0(coldt2_, fwat * dr2)
    fwatr2 = 1.0 - coldt2_ if ms else jnp.where(coldt2, 0.0, 1.0)
    rn = fwatr2 * dr2
    sn = (1.0 - fwatr2) * dr2
    condl2 = condl + fwatr2 * dq * rdt
    condi2 = condi + (1.0 - fwatr2) * dq * rdt
    rfln = rfln + rn
    sfln = sfln + sn
    rfreeze3 = rfreeze + rfreeze2
    aux.update(
        dq=dq, dr2=dr2, coldt2=coldt2, fwatr2=fwatr2,
        condl2=condl2, condi2=condi2, rfreeze3=rfreeze3,
    )

    # output tendencies (reference :366-380)
    tnd_q = -(condl2 + condi2) + (xp["lude"] + evapr + evaps) * gdp
    tmp8 = (
        lvdcp * evapr
        + lsdcp * evaps
        + xp["lude"] * (fwat * lvdcp + (1.0 - fwat) * lsdcp)
        - (lsdcp - lvdcp) * rfreeze3
    )
    tnd_t = lvdcp * condl2 + lsdcp * condi2 - tmp8 * gdp
    tnd_qi = (qiwc - xp["qi_fg"]) * rdt

    outs = {
        "tnd_t": tnd_t,
        "tnd_q": tnd_q,
        "tnd_ql": xp["tnd_ql"],  # fully determined by phase A
        "tnd_qi": tnd_qi,
        "clc": clc,
        "covptot": covptot_out,
        "fplsl": rfln,
        "fplsn": sfln,
    }
    return NLCarry(rfln, sfln, covptot), outs, aux


def nl_level(
    carry: NLCarry,
    x: Dict[str, Array],
    aph_s: Array,
    trpaus: Array,
    dt: float,
    c: Constants,
) -> Tuple[NLCarry, Dict[str, Array], Dict[str, Array]]:
    """One vertical level of the nonlinear scheme.

    ``x`` holds the per-level slices: ``ap, aph0, aph1, lu_next, lude, mfd,
    mfu, q, qi, ql, qsat, supsat, t_fg, tnd_cml_q, tnd_cml_qi, tnd_cml_ql``
    plus the per-level scalars ``eta`` and ``scalm``.

    Composed from the carry-independent :func:`nl_level_pre` (phase A) and
    the carry-dependent :func:`nl_level_post` (phase B) — a pure statement
    reordering of the reference level body.

    Returns ``(carry_out, outs, aux)``; ``aux`` carries every intermediate
    of both phases (debugging / oracle comparisons).
    """
    pre = nl_level_pre(x, aph_s, trpaus, dt, c)
    carry, outs, aux_b = nl_level_post(carry, {**x, **pre}, dt, c)
    return carry, outs, {**pre, **aux_b}


def prepare_level_inputs(state: Dict[str, Array], dt: float, c: Constants) -> Dict[str, Array]:
    """Build the per-level scan inputs from a state dict.

    ``state`` keys follow the reference field names without the ``f_``
    prefix (see ``setup.py:48-65``): full-level ``(nlev, ncols)`` arrays
    ``ap, lu, lude, mfd, mfu, q, qi, ql, qsat, supsat, t, tnd_cml_q,
    tnd_cml_qi, tnd_cml_ql, tnd_cml_t``; interface ``aph`` of shape
    ``(nlev+1, ncols)``; vertical coordinate ``eta`` of shape ``(nlev,)``.
    """
    lu = state["lu"]
    eta = state["eta"]
    # one-level lookahead for the detrainment source; the reference reads
    # in_lu[0, 0, 1], which at the last level falls into the zero-initialized
    # storage padding (cloudsc2.py:212-214) — equivalently lu_next[-1] = 0.
    lu_next = jnp.concatenate([lu[1:], jnp.zeros_like(lu[:1])], axis=0)
    t_fg = state["t"] + dt * state["tnd_cml_t"]
    return {
        "ap": state["ap"],
        "aph0": state["aph"][:-1],
        "aph1": state["aph"][1:],
        "lu_next": lu_next,
        "lude": state["lude"],
        "mfd": state["mfd"],
        "mfu": state["mfu"],
        "q": state["q"],
        "qi": state["qi"],
        "ql": state["ql"],
        "qsat": state["qsat"],
        "supsat": state["supsat"],
        "t_fg": t_fg,
        "tnd_cml_q": state["tnd_cml_q"],
        "tnd_cml_qi": state["tnd_cml_qi"],
        "tnd_cml_ql": state["tnd_cml_ql"],
        "eta": eta,
        "scalm": scalm_profile(eta.astype(lu.dtype), c),
    }


@partial(jax.jit, static_argnames=("c",))
def cloudsc2_nl(
    state: Dict[str, Array], dt: float, c: Constants
) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Run the nonlinear CLOUDSC2 scheme over all levels.

    Returns ``(tendencies, diagnostics)`` with the same fields as the
    reference component (``microphysics.py:104-121``): tendencies
    ``t, q, ql, qi`` of shape ``(nlev, ncols)``; diagnostics ``clc, covptot``
    (full levels) and ``fhpsl, fhpsn, fplsl, fplsn`` (interface levels,
    ``(nlev+1, ncols)``).
    """
    xs = prepare_level_inputs(state, dt, c)
    ncols = state["ap"].shape[1]
    dtype = state["ap"].dtype
    t_fg = xs["t_fg"]
    trpaus = tropopause_eta(state["eta"].astype(dtype), t_fg)
    aph_s = state["aph"][-1]

    def body(carry: NLCarry, x: Dict[str, Array]):
        carry, outs, _ = nl_level(carry, x, aph_s, trpaus, dt, c)
        return carry, outs

    init = NLCarry(
        rfl=jnp.zeros((ncols,), dtype),
        sfl=jnp.zeros((ncols,), dtype),
        covptot=jnp.zeros((ncols,), dtype),
    )
    _, ys = jax.lax.scan(body, init, xs)

    zrow = jnp.zeros((1, ncols), dtype)
    fplsl = jnp.concatenate([zrow, ys["fplsl"]], axis=0)
    fplsn = jnp.concatenate([zrow, ys["fplsn"]], axis=0)
    tends = {
        "t": ys["tnd_t"],
        "q": ys["tnd_q"],
        "ql": ys["tnd_ql"],
        "qi": ys["tnd_qi"],
    }
    diags = {
        "clc": ys["clc"],
        "covptot": ys["covptot"],
        "fplsl": fplsl,
        "fplsn": fplsn,
        "fhpsl": -fplsl * c.RLVTT,
        "fhpsn": -fplsn * c.RLSTT,
    }
    # reference zeroes the top interface of the enthalpy fluxes only
    # (cloudsc2.py:391-394); fplsl/fplsn at the top are zero by construction
    return tends, diags
