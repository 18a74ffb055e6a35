
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Grid description for the CLOUDSC2 framework.

The reference builds a ``ComputationalGrid(GridConfig(nx, ny=1, nz))`` with
symbolic dimensions ``(I, J, K)`` and staggered ``K - 1/2`` interface levels
(reference: ``drivers/run_nonlinear.py:57``, ``setup.py:51``).  The dummy
``J = 1`` axis is a GT4Py artifact; the layout here is simply

    full-level fields      : ``(nlev,     ncols)``
    interface-level fields : ``(nlev + 1, ncols)``
    vertical coordinate    : ``(nlev,)``

with columns on the fast (contiguous) axis and levels on the scan
dimension.  Columns are fully independent; the vertical is a sequential
scan direction and is never sharded.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Grid:
    """A column-physics grid: ``ncols`` independent columns, ``nlev`` levels."""

    ncols: int
    nlev: int

    @property
    def nlev_i(self) -> int:
        """Number of interface (half) levels, reference ``K - 1/2`` grid."""
        return self.nlev + 1

    @property
    def full_shape(self) -> tuple[int, int]:
        return (self.nlev, self.ncols)

    @property
    def iface_shape(self) -> tuple[int, int]:
        return (self.nlev + 1, self.ncols)
