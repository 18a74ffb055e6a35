# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Implementation dispatch: one place mapping an ``impl`` string to the
scheme functions.

``impl`` values (the analogue of the reference's GT4Py ``--backend``
strings, ``run_nonlinear.py:156-158``):

- ``"auto"`` — the GPU kernel of the scheme on a GPU in float32, the
  ``lax.scan`` path otherwise (CPU, float64, and the adjoint without
  linearized physics); see :func:`use_kernel`.
- ``"scan"`` — ``lax.scan`` paths; any platform and precision (the f64
  oracle).
- ``"pallas"`` — the GPU level-scan kernels (:mod:`cloudsc2_tpu.pallas`).
- ``"pallas-interpret"`` — the same kernels in interpret mode (CPU
  testing).

An explicit kernel ``impl`` never falls back: where the kernel cannot run
(float64, or the adjoint with ``LPHYLIN=False``) it raises.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

SCHEMES = ("nl", "tl", "ad")
IMPLS = ("auto", "scan", "pallas", "pallas-interpret")
KERNEL_IMPLS = ("pallas", "pallas-interpret")
#: schemes whose GPU kernel beat the scan path on the card (CHANGES.md)
KERNEL_SCHEMES = ("nl", "tl", "ad")


def scheme_fns(scheme: str) -> Tuple[Callable, Callable]:
    """``(scan, kernel)`` implementations of ``scheme``, each called as
    ``fn(state, dt, c, **kw)``."""
    if scheme == "nl":
        from cloudsc2_tpu.pallas.nonlinear import cloudsc2_nl_pallas
        from cloudsc2_tpu.physics.nonlinear import cloudsc2_nl

        return cloudsc2_nl, cloudsc2_nl_pallas
    if scheme == "tl":
        from cloudsc2_tpu.pallas.tangent_linear import cloudsc2_tl_pallas
        from cloudsc2_tpu.physics.tangent_linear import cloudsc2_tl

        return cloudsc2_tl, cloudsc2_tl_pallas
    if scheme == "ad":
        from cloudsc2_tpu.pallas.adjoint import cloudsc2_ad_pallas
        from cloudsc2_tpu.physics.adjoint import cloudsc2_ad

        return cloudsc2_ad, cloudsc2_ad_pallas
    raise ValueError(f"unknown scheme {scheme!r}; expected one of {SCHEMES}")


def use_kernel(impl: str, scheme: str, dtype: Any, c: Any) -> bool:
    """Whether ``scheme`` runs its kernel for ``impl`` on float ``dtype``
    fields under constants ``c``; raises where an explicit kernel ``impl``
    cannot run."""
    import jax
    import jax.numpy as jnp

    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    runs = (
        scheme in KERNEL_SCHEMES
        and jnp.dtype(dtype) == jnp.float32
        and (scheme != "ad" or c.LPHYLIN)
    )
    if impl == "auto":
        return runs and jax.default_backend() == "gpu"
    if impl == "scan":
        return False
    if not runs:
        raise ValueError(
            f"impl={impl!r}: no {scheme.upper()} kernel for {jnp.dtype(dtype)} "
            f"fields with LPHYLIN={c.LPHYLIN} (the kernels take float32, and "
            "the adjoint kernel needs LPHYLIN=True); use impl='scan'"
        )
    return True


def scheme_fn(scheme: str, impl: str, dtype: Any, c: Any) -> Callable:
    """The ``fn(state, dt, c)`` that runs ``scheme`` ("nl", "tl" or "ad")
    for ``impl``."""
    scan, kernel = scheme_fns(scheme)
    if not use_kernel(impl, scheme, dtype, c):
        return scan
    if impl == "pallas-interpret":
        return lambda state, dt, c: kernel(state, dt, c, interpret=True)
    return kernel
