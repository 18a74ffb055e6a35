
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Mesh construction and state sharding for column-parallel CLOUDSC2.

Layout contract (see :mod:`cloudsc2_tpu.grid`): full-level fields are
``(nlev, ncols)``, interface fields ``(nlev + 1, ncols)``, the eta coordinate
``(nlev,)``.  Columns — the trailing, coalesced axis — are the only
sharded axis; levels are always local because the scheme is a strict
top-down recurrence (reference ``nonlinear/_stencils/cloudsc2.py:93-113,
382-388``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

#: mesh axis names: ``node`` spans hosts (processes), ``device`` spans the
#: cards of one host.  Columns shard over both.
MESH_AXES = ("node", "device")


def initialize_distributed(**kwargs: Any) -> None:
    """Initialize multi-host JAX (no-op when single-process).

    The reference has no multi-process support (SURVEY.md §2.3); this is
    the path to N processes: call once per process before building the
    mesh, with the coordinator address, process count and process id from
    the launcher (``coordinator_address``, ``num_processes``,
    ``process_id``; ``jax.distributed.initialize`` finds them itself only
    where a cluster environment such as SLURM provides them).  On one host
    of several cards, give each process its own card
    (``CUDA_VISIBLE_DEVICES`` or ``local_device_ids``): JAX reserves most of
    a card's memory when it starts, so two processes cannot share one.
    """
    # Do NOT touch any backend-initializing JAX API (jax.process_count,
    # jax.devices, ...) before calling initialize(): that initializes a
    # local-only XLA backend and initialize() then always raises.
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" in str(e).lower():
            return  # the launcher's runtime initialized it already
        raise
    except ValueError:
        # single-process (no coordinator configured anywhere): local devices
        pass


def column_mesh(
    n_devices: int | None = None, *, n_nodes: int | None = None
) -> Mesh:
    """Build the 2-D ``('node', 'device')`` mesh over the first ``n_devices``.

    ``n_nodes`` defaults to ``jax.process_count()`` so the outer axis follows
    process boundaries; the cards of one host are joined all to all
    (NVLink), so the inner axis needs no particular shape.
    With ``n_devices`` given (e.g. in tests or dry runs) the devices are
    factored ``(n_nodes, n_devices // n_nodes)``.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_nodes is None:
        n_nodes = jax.process_count()
        if n_devices % n_nodes != 0:
            n_nodes = 1
    if n_devices % n_nodes != 0:
        raise ValueError(f"{n_devices} devices not divisible by {n_nodes} nodes")
    grid = np.asarray(devices[:n_devices]).reshape(n_nodes, n_devices // n_nodes)
    return Mesh(grid, MESH_AXES)


def column_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``(levels, columns)`` fields: columns over both mesh axes."""
    return NamedSharding(mesh, P(None, MESH_AXES))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully replicated sharding (eta coordinate, scalars)."""
    return NamedSharding(mesh, P())


def state_shardings(state: Dict[str, Any], mesh: Mesh) -> Dict[str, NamedSharding]:
    """Per-field shardings: 2-D fields column-sharded, 1-D fields replicated."""
    col = column_sharding(mesh)
    rep = replicated_sharding(mesh)
    return {k: (col if np.ndim(v) == 2 else rep) for k, v in state.items()}


def shard_state(state: Dict[str, Any], mesh: Mesh) -> Dict[str, jax.Array]:
    """Place a state dict onto the mesh with column sharding.

    On a multi-host mesh (non-addressable shardings) every process must
    hold the same full host array; each then contributes its addressable
    shards via ``make_array_from_callback``.
    """
    shardings = state_shardings(state, mesh)

    def put(v: Any, sh: NamedSharding) -> jax.Array:
        if sh.is_fully_addressable:
            return jax.device_put(v, sh)
        arr = np.asarray(v)
        return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])

    return {k: put(v, shardings[k]) for k, v in state.items()}


def pad_columns(
    state: Dict[str, Any], multiple: int
) -> Tuple[Dict[str, Any], int]:
    """Pad the column axis of every 2-D field up to ``multiple``.

    Padding replicates column 0 (a valid physical column, so padded lanes
    never produce NaN/inf and never affect real columns — columns are
    independent).  Returns ``(padded_state, original_ncols)``.
    """
    ncols = next(v.shape[1] for v in state.values() if np.ndim(v) == 2)
    padded = (-(-ncols // multiple)) * multiple
    if padded == ncols:
        return dict(state), ncols
    pad = padded - ncols

    def _pad(v: Any) -> Any:
        if np.ndim(v) != 2:
            return v
        if isinstance(v, np.ndarray):
            return np.concatenate([v, np.repeat(v[:, :1], pad, axis=1)], axis=1)
        import jax.numpy as jnp

        return jnp.concatenate([v, jnp.repeat(v[:, :1], pad, axis=1)], axis=1)

    return {k: _pad(v) for k, v in state.items()}, ncols


def unpad_columns(fields: Dict[str, Any], ncols: int) -> Dict[str, Any]:
    """Strip column padding from output field dicts."""
    return {k: (v[..., :ncols] if np.ndim(v) == 2 else v) for k, v in fields.items()}


def process_local_block(arr: jax.Array) -> Tuple[np.ndarray, Tuple[int, int]]:
    """This process's contiguous column block of a column-sharded global
    array, as ``(block, (col_start, col_stop))``.

    Multi-host arrays are not fully addressable, so per-process validation
    and D2H must go through the addressable shards.  The column factoring of
    :func:`column_mesh` assigns each process one contiguous column range
    (node-major device order); this is asserted, not assumed.
    """
    ncols = arr.shape[-1]

    def _start(s):
        return s.index[-1].start or 0

    shards = sorted(arr.addressable_shards, key=_start)
    stop = None
    for s in shards:
        start = _start(s)
        if stop is not None and start != stop:
            raise ValueError(f"non-contiguous local column shards at {start} != {stop}")
        stop = s.index[-1].stop if s.index[-1].stop is not None else ncols
    block = np.concatenate([np.asarray(s.data) for s in shards], axis=-1)
    return block, (_start(shards[0]), stop)
