
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Saturation specific-humidity diagnostic.

JAX re-implementation of the reference ``saturation`` stencil
(``src/cloudsc2_gt4py/physics/common/_stencils/saturation.py:23-42``) and its
wrapping component (``physics/common/saturation.py:33-76``).  Pointwise over
``(nlev, ncols)`` arrays; compile-time switches ``KFLAG``/``LPHYLIN`` are
static Python values, as in the reference where they are GT4Py externals.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics import fcttre


@partial(jax.jit, static_argnames=("kflag", "lphylin", "c"))
def saturation(
    ap: jnp.ndarray,
    t: jnp.ndarray,
    *,
    kflag: int = 1,
    lphylin: bool = True,
    c: Constants,
) -> jnp.ndarray:
    """Diagnose ``qsat`` from pressure ``ap`` and temperature ``t``.

    Reference semantics (``saturation.py:29-42``): with ``LPHYLIN`` the
    saturation pressure blends liquid/ice with the ``foealfa`` weight and the
    ratio is clipped at ``QMAX``; otherwise ``foeewm``/``foeewmcu`` is chosen
    by ``KFLAG``.  ``QMAX = ZQMAX = 0.5`` (component ``saturation.py:53``).

    Note the two esat exponentials here cannot be reused for the NL body's
    ``foeew``: saturation is evaluated at the state temperature while the
    scheme re-evaluates at the first-guess ``t + dt*tnd_cml_t``
    (reference ``cloudsc2.py:102-104, 140-160``).
    """
    qmax = c.ZQMAX
    if lphylin:
        alfa = fcttre.foealfa(t, c)
        ew = alfa * fcttre.foeew_liquid(t, c) + (1.0 - alfa) * fcttre.foeew_ice(t, c)
    else:
        ew = fcttre.foeewmcu(t, c) if kflag == 1 else fcttre.foeewm(t, c)
    # divides (bit-identical to the scalar oracle)
    qs = jnp.minimum(ew / ap, qmax)
    return qs / (1.0 - c.RETV * qs)
