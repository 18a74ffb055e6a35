# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Generic GPU level-scan kernel for vertical column physics (Pallas,
Triton route).

All CLOUDSC2 schemes share one execution shape: a strictly sequential
sweep over levels with a small per-column carry, over many independent
columns.  :func:`level_scan_pallas` runs that shape as one kernel:

* a one-dimensional grid over blocks of ``block_cols`` columns; blocks are
  independent and run in any order on the card's SMs;
* inside a block, a ``fori_loop`` over the levels (top-down, or bottom-up
  with ``reverse=True``); each thread owns its columns and the carry stays
  in registers for the whole sweep;
* each level reads one coalesced, masked row of every input
  (``ref.at[k, pl.ds(j * B, B)]``) and writes one row of every output, so
  every stream crosses device memory exactly once; the last block masks
  the columns past ``ncols``, so any column count is accepted;
* per-level scalars (eta, the scaling profile) are scalar loads.

The per-level body is the same function the ``lax.scan`` reference path
runs (``nl_level`` / ``tl_level``), so the two cannot drift.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

Array = jnp.ndarray


def level_scan_pallas(
    body: Callable,
    *,
    level_inputs: Dict[str, Array],
    col_inputs: Dict[str, Array],
    scalar_inputs: Dict[str, Array],
    out_names: Sequence[str],
    ncarry: int,
    block_cols: int,
    num_warps: int,
    reverse: bool = False,
    interpret: bool = False,
    name: str = "level_scan",
) -> Dict[str, Array]:
    """Run ``body`` as a level scan on the GPU.

    ``body(carry, x, col, k)`` receives the carry (a tuple of ``ncarry``
    ``(block_cols,)`` arrays, zero at the first level swept), the per-level
    dict ``x`` (one row of every level input plus the scalar inputs as 0-d
    values), the per-column dict ``col`` and the level index ``k``; it
    returns ``(carry, outs)`` with ``outs`` keyed by ``out_names``.

    ``level_inputs`` are ``(nlev, ncols)``, ``col_inputs`` ``(ncols,)`` and
    ``scalar_inputs`` ``(nlev,)``.  Returns the outputs as ``(nlev, ncols)``
    arrays in the inputs' dtype.
    """
    names = tuple(level_inputs)
    col_names = tuple(col_inputs)
    scal_names = tuple(scalar_inputs)
    out_names = tuple(out_names)
    sample = level_inputs[names[0]]
    nlev, ncols = sample.shape
    dtype = sample.dtype
    for n, v in level_inputs.items():
        if v.shape != (nlev, ncols) or v.dtype != dtype:
            raise ValueError(
                f"level input {n!r} is {v.shape} {v.dtype}; expected "
                f"{(nlev, ncols)} {dtype}"
            )
    if block_cols < 1 or block_cols & (block_cols - 1):
        raise ValueError(f"block_cols={block_cols} must be a power of two")
    nblk = pl.cdiv(ncols, block_cols)
    n_s, n_l, n_c = len(scal_names), len(names), len(col_names)

    def kernel(*refs):
        scal_refs = refs[:n_s]
        level_refs = refs[n_s : n_s + n_l]
        col_refs = refs[n_s + n_l : n_s + n_l + n_c]
        out_refs = refs[n_s + n_l + n_c :]
        c0 = pl.program_id(0) * block_cols
        cols = pl.ds(c0, block_cols)
        # columns past ncols (the last block only) load 1.0, which keeps
        # the physics on those lanes finite; they are never stored
        mask = c0 + jnp.arange(block_cols, dtype=jnp.int32) < ncols
        col = {
            n: plgpu.load(r.at[cols], mask=mask, other=1)
            for n, r in zip(col_names, col_refs)
        }

        def step(i, carry):
            k = nlev - 1 - i if reverse else i
            x = {
                n: plgpu.load(r.at[k, cols], mask=mask, other=1)
                for n, r in zip(names, level_refs)
            }
            for n, r in zip(scal_names, scal_refs):
                x[n] = r[k]
            carry, outs = body(carry, x, col, k)
            for n, r in zip(out_names, out_refs):
                plgpu.store(r.at[k, cols], outs[n].astype(dtype), mask=mask)
            return tuple(carry)

        zero = jnp.zeros((block_cols,), dtype)
        # int32 bounds: the index arithmetic stays int32 under jax_enable_x64
        jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(nlev), step, (zero,) * ncarry
        )

    outs = pl.pallas_call(
        kernel,
        grid=(nblk,),
        out_shape=[jax.ShapeDtypeStruct((nlev, ncols), dtype) for _ in out_names],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name=name,
    )(
        *[scalar_inputs[n].astype(dtype) for n in scal_names],
        *[level_inputs[n] for n in names],
        *[col_inputs[n].astype(dtype) for n in col_names],
    )
    return dict(zip(out_names, outs))
