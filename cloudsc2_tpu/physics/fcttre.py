
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Thermodynamic helper functions (IFS ``fcttre`` function library).

JAX re-implementation of the gtscript function collection in the reference
(``src/cloudsc2_gt4py/physics/common/_stencils/fcttre.py:22-57``).  All
functions are pointwise over arrays of any shape and close over a
:class:`~cloudsc2_tpu.params.Constants` bundle.
"""
from __future__ import annotations

import jax.numpy as jnp

from cloudsc2_tpu.params import Constants


def foealfa(t: jnp.ndarray, c: Constants) -> jnp.ndarray:
    """Liquid fraction of mixed-phase condensate (reference ``fcttre.py:24-27``)."""
    tclamp = jnp.clip(t, c.RTICE, c.RTWAT)
    return jnp.minimum(1.0, ((tclamp - c.RTICE) * c.RTWAT_RTICE_R) ** 2.0)


def foealfcu(t: jnp.ndarray, c: Constants) -> jnp.ndarray:
    """Convective-scheme liquid fraction (reference ``fcttre.py:32-35``)."""
    tclamp = jnp.clip(t, c.RTICECU, c.RTWAT)
    return jnp.minimum(1.0, ((tclamp - c.RTICECU) * c.RTWAT_RTICECU_R) ** 2.0)


def foeew_liquid(t: jnp.ndarray, c: Constants) -> jnp.ndarray:
    """Saturation vapour pressure over liquid water."""
    return c.R2ES * jnp.exp(c.R3LES * (t - c.RTT) / (t - c.R4LES))


def foeew_ice(t: jnp.ndarray, c: Constants) -> jnp.ndarray:
    """Saturation vapour pressure over ice."""
    return c.R2ES * jnp.exp(c.R3IES * (t - c.RTT) / (t - c.R4IES))


def foeewm(t: jnp.ndarray, c: Constants) -> jnp.ndarray:
    """Mixed-phase saturation vapour pressure (reference ``fcttre.py:40-46``)."""
    alfa = foealfa(t, c)
    return alfa * foeew_liquid(t, c) + (1.0 - alfa) * foeew_ice(t, c)


def foeewmcu(t: jnp.ndarray, c: Constants) -> jnp.ndarray:
    """Convective mixed-phase saturation vapour pressure (``fcttre.py:51-57``)."""
    alfa = foealfcu(t, c)
    return alfa * foeew_liquid(t, c) + (1.0 - alfa) * foeew_ice(t, c)
