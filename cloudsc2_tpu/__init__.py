
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""cloudsc2_tpu — a CLOUDSC2 NL/TL/AD column-physics engine for the GPU.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of the
reference ``cloudsc2_gt4py`` package (ECMWF CLOUDSC2 cloud-microphysics
dwarf with tangent-linear and adjoint formulations): columns on the fast
axis, the sequential vertical recurrence as a ``lax.scan`` or as a loop
inside one GPU kernel, column-sharded data parallelism over a
``jax.sharding.Mesh``.
"""
from cloudsc2_tpu.grid import Grid
from cloudsc2_tpu.params import (
    Constants,
    YoethfParams,
    YomcstParams,
    YrecldpParams,
    YrephliParams,
    YrnclParams,
    YrphncParams,
    make_constants,
)

__version__ = "0.1.0"

__all__ = [
    "Grid",
    "Constants",
    "make_constants",
    "YoethfParams",
    "YomcstParams",
    "YrecldpParams",
    "YrephliParams",
    "YrnclParams",
    "YrphncParams",
]
