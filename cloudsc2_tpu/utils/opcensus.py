
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Static op census of traced physics bodies.

Counts the jaxpr primitives of one level of a scheme body.  The flop count
(:func:`flop_count`) is the single source of the reference-schema CSV
MFLOPS column (:data:`cloudsc2_tpu.utils.output.FLOPS_PER_POINT`).  Shape-
only primitives (broadcasts, converts, reshapes) are excluded: they move
no data through an arithmetic unit.
"""
from __future__ import annotations

import collections
from typing import Callable, Counter, Sequence

import jax

#: metadata/layout primitives that compute nothing
NON_ISSUING = frozenset({
    "broadcast_in_dim", "convert_element_type", "reshape", "squeeze",
    "slice", "concatenate", "transpose", "copy", "stop_gradient",
})


def census(fn: Callable, args: Sequence) -> Counter:
    """Primitive counts of ``fn(*args)`` (recursing into sub-jaxprs)."""
    jaxpr = jax.make_jaxpr(fn)(*args)
    counts: Counter = collections.Counter()

    def walk(jx):
        for eqn in jx.eqns:
            counts[eqn.primitive.name] += 1
            for p in eqn.params.values():
                if hasattr(p, "jaxpr"):
                    walk(p.jaxpr)
                if isinstance(p, (list, tuple)):
                    for q in p:
                        if hasattr(q, "jaxpr"):
                            walk(q.jaxpr)

    walk(jaxpr.jaxpr)
    return counts


#: non-arithmetic computational primitives: executed, but not
#: floating-point *operations* in the MFLOPS sense (comparisons, boolean
#: algebra, selects).  min/max ARE counted as flops (one ALU op on data).
NON_FLOP = frozenset({
    "gt", "lt", "ge", "le", "eq", "ne", "and", "or", "not", "xor",
    "select_n", "sign", "is_finite", "iota", "reduce_and", "reduce_or",
})


def issue_count(counts: Counter) -> int:
    """Executed ops, one per computational primitive (shape plumbing
    excluded)."""
    return sum(v for k, v in counts.items() if k not in NON_ISSUING)


def flop_count(counts: Counter) -> int:
    """Floating-point operations in the classic MFLOPS sense: arithmetic
    primitives only (each transcendental = 1 flop, as Fortran op counts do);
    comparisons/selects/logicals excluded.  This is the single source of
    truth for the reference-schema CSV MFLOPS column
    (:data:`cloudsc2_tpu.utils.output.FLOPS_PER_POINT`)."""
    return sum(
        v for k, v in counts.items() if k not in NON_ISSUING and k not in NON_FLOP
    )


def nl_step_ops_per_column(c, dt: float, nlev: int) -> dict:
    """Per-column op counts of the full forward step (saturation + NL),
    the unit ``bench.py`` times.

    Counts one level of :func:`~cloudsc2_tpu.physics.nonlinear.nl_level`
    (traced on the folded input streams exactly as the kernel wrapper
    feeds it) plus one level of the saturation, and multiplies by
    ``nlev``.  The per-column assembly outside the level bodies
    (first-guess combines, fhpsl/fhpsn scalings — ~10 ops per level-column)
    is excluded.
    """
    import jax.numpy as jnp

    from cloudsc2_tpu.physics.nonlinear import NLCarry, nl_level
    from cloudsc2_tpu.physics.saturation import saturation

    col = jnp.ones((8,), jnp.float32)
    x = {k: col for k in (
        "ap", "dp", "lu_next", "lude", "mfd", "mfu", "q2", "ql_fg", "qi_fg",
        "qsat", "t_fg", "crh_rh2", "crh_deta1", "crh_rsq",
    )}
    x["eta"] = jnp.float32(0.5)
    x["scalm"] = jnp.float32(0.1)
    carry = NLCarry(col, col, col)
    level_fn = lambda cr, xx: nl_level(cr, xx, col, col, dt, c)[:2]  # noqa: E731
    nl_counts = census(level_fn, (carry, x))
    sat_counts = census(
        lambda ap, t: saturation(ap, t, kflag=1, lphylin=c.LPHYLIN, c=c),
        (col, col),
    )
    return {
        "issue_ops_per_col": (issue_count(nl_counts) + issue_count(sat_counts)) * nlev,
        "flops_per_col": (flop_count(nl_counts) + flop_count(sat_counts)) * nlev,
    }
