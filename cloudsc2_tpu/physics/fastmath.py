
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Arithmetic helpers for the level bodies.

* :func:`fmask` / :func:`sel0` — the two forms of branch predication
  selected by ``Constants.MASK_SELECT`` (a vector select, or a multiply by
  a float mask).
* :func:`fast_exp` — a faithful float32 exponential evaluated as
  ``2^k * exp(r)`` with a Cody-Waite range reduction (k = rint(x*log2e),
  r = x - k*ln2 split in two constants so the reduction is exact in f32)
  and a degree-7 Taylor polynomial on |r| <= ln2/2, scaled by 2^k through
  exponent-bit assembly.  Maximum relative error ~2-3 f32 ulps over the
  scheme's argument range (``tests/test_nonlinear.py::
  test_fast_exp_faithful``).  No level body calls it; float64 inputs fall
  through to ``jnp.exp``.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def fmask(p: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """Boolean predicate as a float {0, 1} mask in ``ref``'s dtype.

    Used by the ``Constants.MASK_SELECT`` mode of the level bodies: the
    branch-predication pattern ``where(p, x, 0)`` becomes the multiply
    ``x * fmask(p, x)`` — bit-exact for finite ``x`` (``x*1 == x``,
    ``x*0 == 0``), one multiply instead of a select.
    The conversion is paid once per predicate and shared by every select
    on it (the TL body pairs each forward select with a perturbation
    select on the same predicate).
    """
    return p.astype(ref.dtype)


def sel0(p_or_m: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """``where(p, x, 0)`` — select on a bool predicate, multiply on a mask.

    Callers pass either the raw boolean predicate (``MASK_SELECT=False``:
    lowers to a vector select) or its :func:`fmask` (``MASK_SELECT=True``:
    lowers to a multiply).  The two forms are bit-identical for finite
    ``x``; the additive-update pattern ``where(p, a+b, a)`` is written
    ``a + sel0(p, b)`` (identical up to the sign of a zero).
    """
    if p_or_m.dtype == jnp.bool_:
        return jnp.where(p_or_m, x, jnp.zeros_like(x))
    return x * p_or_m

LOG2E = 1.4426950408889634
# Cody-Waite split of ln2: hi has its low mantissa bits zeroed so k*LN2_HI
# is exact for |k| < 2^15; lo carries the remainder
LN2_HI = 0.693359375
LN2_LO = -2.12194440e-4
#: Taylor coefficients 1/k! for exp(r) on |r| <= ln2/2
_COEF = tuple(1.0 / math.factorial(k) for k in range(8))


def fast_exp(x: jnp.ndarray) -> jnp.ndarray:
    """exp(x), faithful to ~2-3 ulps for float32; jnp.exp for other dtypes."""
    if x.dtype != jnp.float32:
        return jnp.exp(x)
    # clamp in the x domain BEFORE reduction: a huge-magnitude argument
    # (e.g. the autoconversion -(cldl/lcrit)^2 with a tiny cloud fraction)
    # must not reach the polynomial with an unreduced remainder.
    # exp(-87) ~ 1.6e-38 (f32 min normal) and exp(88) is near f32 max.
    x = jnp.clip(x, -87.0, 88.0)
    y = x * jnp.float32(LOG2E)
    k = jax.lax.round(y, jax.lax.RoundingMethod.TO_NEAREST_EVEN)
    # exact range reduction in the original domain (Cody-Waite)
    r = (x - k * jnp.float32(LN2_HI)) - k * jnp.float32(LN2_LO)
    p = jnp.float32(_COEF[7])
    for c in _COEF[6::-1]:
        p = p * r + jnp.float32(c)
    ki = k.astype(jnp.int32)
    scale = jax.lax.bitcast_convert_type(
        jax.lax.shift_left(ki + jnp.int32(127), jnp.int32(23)), jnp.float32
    )
    return p * scale
