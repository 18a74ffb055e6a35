
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Sharded step functions: the full NL + TL + AD pipeline under one ``jit``.

The framework's "training step" analogue is the complete symmetry-test
pipeline (reference ``physics/adjoint/validation.py:132-165``): saturation →
state increment → tangent-linear (forward + directional derivative) →
adjoint (forward recompute + reverse sweep) → the two validation norms.
It exercises every kernel plus the only collectives in the system (the
global max over per-column norms).  Under a column-sharded mesh the whole
pipeline is embarrassingly parallel except that final reduction.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from cloudsc2_tpu.dispatch import scheme_fn
from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.parallel.mesh import state_shardings
from cloudsc2_tpu.physics.adjoint import cloudsc2_ad
from cloudsc2_tpu.physics.diagnostics import eta_levels
from cloudsc2_tpu.physics.increment import state_increment
from cloudsc2_tpu.physics.saturation import saturation
from cloudsc2_tpu.physics.tangent_linear import cloudsc2_tl
from cloudsc2_tpu.validation.symmetry import (
    DIAG_NAMES,
    TEND_NAMES,
    SymmetryTest,
)

Array = jnp.ndarray


def forward_step(
    state: Dict[str, Array], dt: float, c: Constants, impl: str = "auto"
) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Saturation + nonlinear scheme (the reference hot loop,
    ``drivers/run_nonlinear.py:115-119``); ``impl`` picks the NL
    implementation through :func:`cloudsc2_tpu.dispatch.scheme_fn`.
    ``diags["qsat"]`` carries the Saturation component's output.

    A caller-provided ``state["eta"]`` is used as-is; eta is only derived
    here when missing.  This matters under ``shard_map``: eta is defined
    from the *global* column 0 (reference ``common/diagnostics.py:28-45``),
    so a shard-local recompute would silently diverge whenever ``ap/aph_s``
    varies per column — :func:`make_sharded_forward_step` computes it once
    globally and passes it in replicated.  Hot loops should pass eta in,
    as the drivers (EtaLevels before the timed loop) do.
    """
    s = dict(state)
    if "eta" not in s:
        s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    tends, diags = scheme_fn("nl", impl, s["ap"].dtype, c)(s, dt, c)
    return tends, dict(diags, qsat=s["qsat"])


def full_step(
    state: Dict[str, Array], dt: float, c: Constants, factor: float = 0.01
) -> Tuple[Dict[str, Array], Array, Array]:
    """The complete NL + TL + AD pipeline with symmetry norms.

    Returns ``(nl_tendencies, norm1, norm2)`` where the norms are the
    per-column ``<Mx, Mx>`` and ``<x, M*(Mx)>`` of the symmetry test.

    It runs the ``lax.scan`` paths, which GSPMD partitions by columns
    (:func:`make_sharded_fn`); GSPMD cannot partition a kernel call, so the
    kernels run sharded only per device, under ``shard_map``
    (:func:`make_sharded_physics`, :func:`make_sharded_forward_step`).
    """
    s = dict(state)
    if "eta" not in s:
        # under jit/GSPMD this reads the global column 0 (correct); only
        # shard_map callers must pass eta in (see forward_step docstring)
        s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)

    incr = state_increment(s, factor, ignore_supsat=True)
    s.update(incr)
    tends_tl, diags_tl = cloudsc2_tl(s, dt, c)
    # the TL computes the full forward trajectory alongside the directional
    # derivative and returns the forward tendencies (reference TL outputs
    # ``out_tnd_*``, ``tangent_linear/microphysics.py:46-242``) — reuse
    # them instead of re-running the NL scheme; the reference's symmetry
    # protocol does the same (``adjoint/validation.py:132-151``)
    tends_nl = {n: tends_tl[n] for n in TEND_NAMES}
    norm1 = SymmetryTest.get_norm1(tends_tl, diags_tl)

    for name in TEND_NAMES:
        s["tnd_" + name] = tends_tl[name]
        s["tnd_" + name + "_i"] = tends_tl[name + "_i"]
    for name in DIAG_NAMES:
        s[name + "_i"] = diags_tl[name + "_i"]
    tends_ad, diags_ad = cloudsc2_ad(s, dt, c)
    norm2 = SymmetryTest.get_norm2(incr, tends_ad, diags_ad)
    return tends_nl, norm1, norm2


def make_sharded_fn(fn, mesh: Mesh, state: Dict[str, Array], *, dt: float, c: Constants):
    """Jit ``fn(state, dt, c)`` with column shardings pinned on the inputs.

    Outputs inherit shardings from the computation (GSPMD propagation); the
    vertical scan is local, so no resharding occurs in the hot path.
    """
    in_shardings = (state_shardings(state, mesh),)
    return jax.jit(
        partial(fn, dt=dt, c=c),
        in_shardings=in_shardings,
    )


def make_sharded_physics(fn, mesh: Mesh):
    """Wrap a physics scheme ``fn(state, dt, c) -> (dict, dict)`` to run
    column-sharded under ``shard_map`` on ``mesh``.

    The generic sibling of :func:`make_sharded_forward_step` used by the
    Taylor/symmetry protocols (driver ``--sharded``): 2-D fields are
    column-sharded, 1-D fields (eta) replicated; each device runs the
    scheme on its local column shard — no communication, columns are
    independent (SURVEY.md §2.3).  Works for the ``lax.scan`` paths and the
    GPU kernels alike (GSPMD cannot partition a ``pallas_call``, so the
    kernels need ``shard_map``).  One compiled step per (dt, c, state
    structure) — the returned callable is constructed once per protocol
    run and reused.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from cloudsc2_tpu.parallel.mesh import MESH_AXES

    spec2d = P(None, MESH_AXES)
    nshards = mesh.devices.size

    @partial(jax.jit, static_argnames=("dt", "c"))
    def step(state, dt, c):
        def local_fn(s):
            return fn(s, dt, c)

        def spec_for(v):
            return spec2d if v.ndim == 2 else P()

        in_specs = ({k: spec_for(v) for k, v in state.items()},)
        # discover the output key sets on the PER-DEVICE shard shapes
        local_abs = {
            k: jax.ShapeDtypeStruct(
                (v.shape[0], v.shape[1] // nshards) if v.ndim == 2 else v.shape,
                v.dtype,
            )
            for k, v in state.items()
        }
        out_abs = jax.eval_shape(local_fn, local_abs)
        out_specs = tuple({k: spec2d for k in d} for d in out_abs)
        return shard_map(
            local_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )(state)

    return step


def make_sharded_forward_step(
    mesh: Mesh, *, dt: float, c: Constants, impl: str = "auto"
):
    """Column-sharded forward step via ``shard_map``.

    GSPMD cannot partition a ``pallas_call`` automatically, so the kernel
    path runs under ``shard_map``: each device executes the kernel on its
    local column shard; there is no communication — columns are
    independent (SURVEY.md §2.3).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from cloudsc2_tpu.parallel.mesh import MESH_AXES

    spec2d = P(None, MESH_AXES)

    def local_fn(state):
        return forward_step(state, dt, c, impl=impl)

    def wrapped(state):
        # 1-D fields (the eta coordinate) are replicated; 2-D fields are
        # column-sharded (same rank rule as mesh.state_shardings)
        def spec_for(v):
            return spec2d if v.ndim == 2 else P()

        in_specs = ({k: spec_for(v) for k, v in state.items()},)
        # discover the diag key set by abstractly tracing on the
        # PER-DEVICE shard shapes
        nshards = mesh.devices.size
        local_abs = {
            k: jax.ShapeDtypeStruct(
                (v.shape[0], v.shape[1] // nshards) if v.ndim == 2 else v.shape,
                v.dtype,
            )
            for k, v in state.items()
        }
        diag_keys = jax.eval_shape(local_fn, local_abs)[1].keys()
        out_specs = ({k: spec2d for k in ("t", "q", "ql", "qi")},
                     {k: spec2d for k in diag_keys})
        # check_vma=False: pallas_call outputs carry no varying-mesh-axis
        # annotation; the kernel is purely local so the check adds nothing
        return shard_map(
            local_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )(state)

    jitted = jax.jit(wrapped)

    def call(state):
        # eta is defined from the GLOBAL column 0 (reference
        # common/diagnostics.py:28-45) — a shard-local recompute inside
        # shard_map would silently diverge whenever ap/aph_s varies per
        # column.  It is also loop-invariant, so derive it once here,
        # eagerly and replicated, keeping the hot compiled step free of
        # collectives (columns are independent, SURVEY.md §2.3).
        if "eta" not in state:
            state = dict(state)
            eta = eta_levels(state["ap"], state["aph"])
            state["eta"] = jax.device_put(
                eta, jax.sharding.NamedSharding(mesh, P())
            )
        return jitted(state)

    call.jitted = jitted  # the hot compiled step, exposed for HLO inspection
    return call
