
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Saturation-adjustment clipping (``cuadjtqs``): NL, TL and AD variants.

JAX re-implementation of the reference gtscript functions:

* nonlinear: ``physics/nonlinear/_stencils/cuadjtqs.py:22-68``
* tangent-linear: ``physics/tangent_linear/_stencils/cuadjtqs.py:22-84``
* adjoint: ``physics/adjoint/_stencils/cuadjtqs.py:22-158``

Two fixed Newton-like iterations; the phase constants (liquid vs ice) are
selected ONCE from the input temperature and held fixed across both
iterations, exactly as in the reference (``ICALL == 0`` path).  All functions
are pointwise over arrays of any shape.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics.fastmath import fmask, sel0


class _Phase(NamedTuple):
    z3es: jnp.ndarray
    z4es: jnp.ndarray
    z5alcp: jnp.ndarray
    zaldcp: jnp.ndarray


def _select_phase(t: jnp.ndarray, c: Constants) -> _Phase:
    """Liquid constants for ``t > RTT``, ice otherwise (reference ``:54-63``)."""
    warm = t > c.RTT
    return _Phase(
        z3es=jnp.where(warm, c.R3LES, c.R3IES),
        z4es=jnp.where(warm, c.R4LES, c.R4IES),
        z5alcp=jnp.where(warm, c.R5ALVCP, c.R5ALSCP),
        zaldcp=jnp.where(warm, c.RALVDCP, c.RALSDCP),
    )


def _nl_iter(ap, t, q, p: _Phase, c: Constants, rap=None):
    """One adjustment iteration (reference ``f_cuadjtqs_nl_0``, ``:24-35``).

    One reciprocal of ``t - z4es`` serves both the saturation-pressure
    exponent and ``z2s`` (replacing two of the four divides).

    The default ``CUADJ_COMPACT`` form is the exact algebraic collapse of
    the reference's ``cor``-based expression (multiply the condensation
    quotient through by ``u^2`` where ``u = 1 - RETV*qsat``):

        cond = (q*u - s) * u / (u*u + s*z2s),   s = min(foeew/ap, ZQMAX)

    which removes TWO carry-chain divides per iteration (``cor`` and the
    shared ``foeew/ap`` via the precomputed off-chain ``rap``) — the top of
    the critical-path census worklist (``benchmarks/critpath_report.py``:
    the two cuadjtqs iterations carry ~135 of the 161 weighted ops on the
    level recurrence).  ``u`` is well-conditioned (``s <= 0.5`` so
    ``u >= 0.7``); the re-association is exact algebra, within ~1 ulp of
    the reference form (absorbed by the oracle/golden tolerances, see
    CLAUDE.md).  ``CUADJ_COMPACT=False`` keeps the reference-shaped form
    for A/B measurement.
    """
    rt4 = 1.0 / (t - p.z4es)
    foeew = c.R2ES * jnp.exp(p.z3es * (t - c.RTT) * rt4)
    if c.CUADJ_COMPACT:
        s = jnp.minimum(foeew * (rap if rap is not None else 1.0 / ap), c.ZQMAX)
        u = 1.0 - c.RETV * s
        z2s = p.z5alcp * rt4 * rt4
        cond = (q * u - s) * u / (u * u + s * z2s)
    else:
        qsat0 = foeew / ap
        qsat = jnp.minimum(qsat0, c.ZQMAX)
        cor = 1.0 / (1.0 - c.RETV * qsat)
        qsat = qsat * cor
        z2s = p.z5alcp * rt4 * rt4
        cond = (q - qsat) / (1.0 + qsat * cor * z2s)
    return t + p.zaldcp * cond, q - cond


def cuadjtqs_nl(ap, t, q, c: Constants, rap=None):
    """Nonlinear two-iteration saturation adjustment."""
    p = _select_phase(t, c)
    t, q = _nl_iter(ap, t, q, p, c, rap)
    t, q = _nl_iter(ap, t, q, p, c, rap)
    return t, q


def _tl_iter(ap, ap_i, t, t_i, q, q_i, p: _Phase, c: Constants, qp=None):
    """One TL iteration (reference ``f_cuadjtqs_tl_0``, ``:24-51``).

    Strength-reduced: one reciprocal each of ``ap``, ``t - z4es``,
    ``1 - RETV*qsat`` and the condensation denominator serve every quotient
    (the reference spends ~8 divides per iteration on the same four
    denominators).  ``qp`` optionally supplies the iteration-invariant
    ``1/ap`` (hoisted across both iterations by the caller).
    """
    if qp is None:
        qp = 1.0 / ap
    qp_i = -ap_i * qp * qp
    rt4 = 1.0 / (t - p.z4es)
    foeew = c.R2ES * jnp.exp(p.z3es * (t - c.RTT) * rt4)
    foeew_i = foeew * p.z3es * t_i * (c.RTT - p.z4es) * rt4 * rt4
    qsat = qp * foeew
    qsat_i = qp_i * foeew + qp * foeew_i
    # the value clip is a plain min (the NL form); the perturbation
    # vanishes on the clipped branch (reference ``:33-35``)
    noclip = qsat <= c.ZQMAX
    qsat = jnp.minimum(qsat, c.ZQMAX)
    qsat_i = sel0(fmask(noclip, qsat) if c.MASK_SELECT else noclip, qsat_i)
    z2s = p.z5alcp * rt4 * rt4
    z2s_i = -2.0 * z2s * t_i * rt4
    if c.CUADJ_COMPACT:
        # derivative of the compact cor-free form (see ``_nl_iter``):
        # cond = (q*u - s)*u / (u*u + s*z2s), u = 1 - RETV*s.  One shared
        # reciprocal of the denominator serves value and perturbation
        # (old form: two extra divides through ``cor``).
        s, s_i = qsat, qsat_i
        u = 1.0 - c.RETV * s
        u_i = -c.RETV * s_i
        w = q * u - s
        num = w * u
        den = u * u + s * z2s
        num_i = (q_i * u + q * u_i - s_i) * u + w * u_i
        den_i = 2.0 * u * u_i + s_i * z2s + s * z2s_i
        rden = 1.0 / den
        cond = num * rden
        cond_i = (num_i - cond * den_i) * rden
    else:
        cor = 1.0 / (1.0 - c.RETV * qsat)
        cor_i = c.RETV * qsat_i * cor * cor
        qsat_i = qsat_i * cor + qsat * cor_i
        qsat = qsat * cor
        rdenom = 1.0 / (1.0 + qsat * cor * z2s)
        cond = (q - qsat) * rdenom
        cond_i = (q_i - qsat_i) * rdenom - (q - qsat) * (
            qsat_i * cor * z2s + qsat * cor_i * z2s + qsat * cor * z2s_i
        ) * rdenom * rdenom
    return t + p.zaldcp * cond, t_i + p.zaldcp * cond_i, q - cond, q_i - cond_i


def cuadjtqs_tl(ap, ap_i, t, t_i, q, q_i, c: Constants):
    """Tangent-linear two-iteration saturation adjustment."""
    p = _select_phase(t, c)
    qp = 1.0 / ap  # iteration-invariant: one reciprocal for both
    t, t_i, q, q_i = _tl_iter(ap, ap_i, t, t_i, q, q_i, p, c, qp)
    t, t_i, q, q_i = _tl_iter(ap, ap_i, t, t_i, q, q_i, p, c, qp)
    return t, t_i, q, q_i


def _fwd_iter_traj(ap, t, q, p: _Phase, c: Constants, rap=None):
    """Forward iteration storing the trajectory needed by the reverse sweep."""
    rt4 = 1.0 / (t - p.z4es)
    foeew = c.R2ES * jnp.exp(p.z3es * (t - c.RTT) * rt4)
    if c.CUADJ_COMPACT:
        s0 = foeew * (rap if rap is not None else 1.0 / ap)
        clip = s0 > c.ZQMAX
        s = jnp.where(clip, c.ZQMAX, s0)
        u = 1.0 - c.RETV * s
        z2s = p.z5alcp * rt4 * rt4
        w = q * u - s
        rden = 1.0 / (u * u + s * z2s)
        cond = w * u * rden
        traj = (t, q, foeew, s, u, z2s, w, rden, rt4, clip)
        return t + p.zaldcp * cond, q - cond, traj
    qsat0 = foeew / ap
    clip = qsat0 > c.ZQMAX
    qsat_unc = jnp.where(clip, c.ZQMAX, qsat0)
    cor = 1.0 / (1.0 - c.RETV * qsat_unc)
    qsat = qsat_unc * cor
    z2s = p.z5alcp * rt4 * rt4
    cond = (q - qsat) / (1.0 + qsat * cor * z2s)
    traj = (t, q, foeew, qsat_unc, qsat, cor, z2s, clip)
    return t + p.zaldcp * cond, q - cond, traj


def cuadjtqs_ad(ap, ap_i, t, t_i, q, q_i, c: Constants):
    """Adjoint of the two-iteration saturation adjustment.

    Matches the reference hand-written adjoint
    (``physics/adjoint/_stencils/cuadjtqs.py:52-158``): recompute both
    iterations storing per-iteration trajectory, then sweep back through
    iteration 2 and iteration 1.  Returns ``(ap_i, t, t_i, q, q_i)`` where
    ``t, q`` are the adjusted (forward) values.  The ``CUADJ_COMPACT``
    branch is the exact transpose of the compact TL form (asserted against
    ``jax.vjp`` of :func:`cuadjtqs_nl` by
    ``tests/test_adjoint.py::test_cuadjtqs_ad_matches_vjp``).
    """
    p = _select_phase(t, c)
    rap = 1.0 / ap
    if c.CUADJ_COMPACT:
        t1, q1, traj1 = _fwd_iter_traj(ap, t, q, p, c, rap)
        t2, q2, traj2 = _fwd_iter_traj(ap, t1, q1, p, c, rap)
        qp_i = jnp.zeros_like(ap)
        for traj in (traj2, traj1):
            targ, q_in, foeew, s, u, z2s, w, rden, rt4, clip = traj
            cond_b = p.zaldcp * t_i - q_i
            w_b = u * rden * cond_b
            u_b = w * rden * cond_b
            den_b = -(w * u) * rden * rden * cond_b
            u_b = u_b + 2.0 * u * den_b
            s_b = z2s * den_b
            z2s_b = s * den_b
            q_i = q_i + u * w_b
            u_b = u_b + q_in * w_b
            s_b = s_b - w_b
            s_b = s_b - c.RETV * u_b
            s_b = jnp.where(clip, 0.0, s_b)
            foeew_b = rap * s_b
            qp_i = qp_i + foeew * s_b
            rt4_b = 2.0 * p.z5alcp * rt4 * z2s_b
            e_b = foeew * foeew_b
            t_i = t_i + p.z3es * rt4 * e_b
            rt4_b = rt4_b + p.z3es * (targ - c.RTT) * e_b
            t_i = t_i - rt4 * rt4 * rt4_b
        ap_i = ap_i - qp_i * rap * rap
        return ap_i, t2, t_i, q2, q_i

    t1, q1, traj1 = _fwd_iter_traj(ap, t, q, p, c)
    t2, q2, traj2 = _fwd_iter_traj(ap, t1, q1, p, c)

    qp_i = jnp.zeros_like(ap)
    for traj in (traj2, traj1):
        targ, q_in, foeew, qsat_unc, qsat, cor, z2s, clip = traj
        cond1_i = -q_i + p.zaldcp * t_i
        rdenom = 1.0 / (1.0 + qsat * cor * z2s)
        rt4 = 1.0 / (targ - p.z4es)
        q_i = q_i + cond1_i * rdenom
        wgt = cond1_i * (q_in - qsat) * rdenom * rdenom
        qsat_i = -cond1_i * rdenom - wgt * cor * z2s
        cor_i = -wgt * qsat * z2s
        z2s_i = -wgt * qsat * cor
        targ_i = -2.0 * z2s_i * p.z5alcp * rt4 * rt4 * rt4
        cor_i = cor_i + qsat_i * qsat_unc
        qsat_i = qsat_i * cor
        qsat_i = qsat_i + cor_i * c.RETV * cor * cor
        qsat_i = jnp.where(clip, 0.0, qsat_i)
        foeew_i = qsat_i / ap
        qp_i = qp_i + qsat_i * foeew
        targ_i = targ_i + (
            foeew_i
            * p.z3es
            * (c.RTT - p.z4es)
            * foeew
            * rt4
            * rt4
        )
        t_i = t_i + targ_i
    ap_i = ap_i - qp_i / ap**2.0
    return ap_i, t2, t_i, q2, q_i
