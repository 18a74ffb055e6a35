
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLOUDSC2 adjoint scheme, JAX formulation.

Capability parity with the reference ``cloudsc2_ad`` gtscript stencil
(``src/cloudsc2_gt4py/physics/adjoint/_stencils/cloudsc2.py:24-996``) and its
component (``physics/adjoint/microphysics.py:46-238``), built by transposition.

Design
------
The reference hand-writes a 996-line adjoint: a forward sweep that re-runs
the nonlinear scheme while materializing ~35 trajectory temporaries, then a
``computation(BACKWARD)`` sweep that re-derives every branch condition and
accumulates cotangents level by level.  Hand-transposing 774 lines of TL
code is exactly the kind of error-prone bookkeeping a functional framework
should eliminate, so here the adjoint is obtained by *transposing the
hand-derived tangent-linear operator*:

* :func:`cloudsc2_tpu.physics.tangent_linear.cloudsc2_tl` is **exactly
  linear** in the 16 perturbation inputs — every branch condition
  (``jnp.where`` predicate) depends only on the forward trajectory, never on
  a ``*_i`` variable (mirroring the reference TL, whose ``if`` conditions
  are all on forward quantities).
* Therefore ``jax.vjp`` of the TL perturbation map *is* the adjoint
  operator, bit-exactly the transpose M* of the regularized TL M, including
  the four ``LREGCL`` damping factors (which the reference mirrors by hand
  at ``adjoint/_stencils/cloudsc2.py:585-587, 751-757, 774-779, 829-832,
  896-902``).  The symmetry property ``<Mx, Mx> == <x, M*(Mx)>`` then holds
  to machine rounding *by construction*, which is what the reference's
  symmetry test demands (``adjoint/validation.py:155-165``).
* Memory: the TL scan body is wrapped in ``jax.checkpoint`` (``remat=True``)
  so the reverse sweep stores only the 6-vector carried state per level and
  recomputes intermediates — the same recompute-vs-store trade the reference
  adjoint makes, expressed as a one-line rematerialization policy.

One deliberate deviation, documented for the record: the reference adjoint
maps the vapour cotangent onto the supersaturation input scaled by the
timestep (``out_supsat_i = dt * out_q_i``, ``adjoint/_stencils/
cloudsc2.py:992``) although the forward first guess adds ``supsat``
*unscaled* (``q = in_q + dt*in_tnd_cml_q + in_supsat``, NL ``:115``, TL
``:151-152``).  The true transpose coefficient is 1, which is what this
implementation produces.  The discrepancy is invisible to the reference's
own symmetry test because it zeroes the supsat increment
(``ignore_supsat=True``, ``adjoint/validation.py:116-122``).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics.increment import INCREMENT_FIELDS
from cloudsc2_tpu.physics.tangent_linear import cloudsc2_tl

Array = jnp.ndarray

#: cotangent seeds consumed from the state: TL tendency outputs ...
AD_TEND_SEEDS = ("tnd_t_i", "tnd_q_i", "tnd_ql_i", "tnd_qi_i")
#: ... and TL diagnostic outputs (reference AD inputs ``in_*_i``,
#: ``adjoint/microphysics.py:64-106``)
AD_DIAG_SEEDS = ("clc_i", "covptot_i", "fhpsl_i", "fhpsn_i", "fplsl_i", "fplsn_i")

#: input-side cotangents returned among the diagnostics (reference
#: ``adjoint/microphysics.py:150-218``; compared pairwise in
#: ``adjoint/validation.py:195-213``)
AD_COTANGENT_FIELDS = (
    "ap",
    "aph",
    "t",
    "q",
    "qsat",
    "ql",
    "qi",
    "lu",
    "lude",
    "mfd",
    "mfu",
    "supsat",
)


@partial(jax.jit, static_argnames=("c",))
def cloudsc2_ad(
    state: Dict[str, Array], dt: float, c: Constants
) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Run the adjoint CLOUDSC2 scheme.

    ``state`` must contain the 16 forward input fields plus ``eta`` and
    ``qsat``, and the output-side cotangent seeds named after the TL
    outputs: ``tnd_{t,q,ql,qi}_i`` (shape ``(nlev, ncols)``), ``clc_i``,
    ``covptot_i`` (full levels) and ``fhpsl_i, fhpsn_i, fplsl_i, fplsn_i``
    (interface levels, ``(nlev+1, ncols)``).

    Returns ``(tendencies, diagnostics)`` mirroring the reference component:

    * tendencies: recomputed forward ``t, q, ql, qi`` plus the cumulative
      -tendency cotangents ``cml_{t,q,ql,qi}_i``;
    * diagnostics: recomputed forward ``clc, covptot, fplsl, fplsn, fhpsl,
      fhpsn`` plus the 12 input cotangents ``{ap,aph,t,q,qsat,ql,qi,lu,
      lude,mfd,mfu,supsat}_i``.
    """
    fwd = {k: v for k, v in state.items() if not k.endswith("_i")}

    def tl_pert(incr: Dict[str, Array]):
        return cloudsc2_tl({**fwd, **incr}, dt, c, remat=True)

    incr0 = {name + "_i": jnp.zeros_like(fwd[name]) for name in INCREMENT_FIELDS}
    (tends_tl, diags_tl), vjp_fn = jax.vjp(tl_pert, incr0)

    # cotangent seeds: zero on the forward outputs, the state-provided seeds
    # on the perturbation outputs
    seed_tends = {k: jnp.zeros_like(v) for k, v in tends_tl.items()}
    for name in ("t", "q", "ql", "qi"):
        seed_tends[name + "_i"] = state["tnd_" + name + "_i"]
    seed_diags = {k: jnp.zeros_like(v) for k, v in diags_tl.items()}
    for seed in AD_DIAG_SEEDS:
        seed_diags[seed] = state[seed]

    (cot,) = vjp_fn((seed_tends, seed_diags))

    tends = {name: tends_tl[name] for name in ("t", "q", "ql", "qi")}
    # reverse-mode map onto the cumulative tendencies: the first guess adds
    # dt * tnd_cml_* (reference adjoint/_stencils/cloudsc2.py:993-996), and
    # the transpose of that scaling is produced by the vjp directly
    for name in ("t", "q", "ql", "qi"):
        tends["cml_" + name + "_i"] = cot["tnd_cml_" + name + "_i"]

    diags = {
        name: diags_tl[name]
        for name in ("clc", "covptot", "fplsl", "fplsn", "fhpsl", "fhpsn")
    }
    for name in AD_COTANGENT_FIELDS:
        diags[name + "_i"] = cot[name + "_i"]
    return tends, diags
