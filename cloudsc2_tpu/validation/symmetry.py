
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Symmetry test: validates the adjoint against the tangent-linear.

Re-implements the reference protocol
(``src/cloudsc2_gt4py/physics/adjoint/validation.py:44-231``): with
``y = M x`` (TL applied to the increment ``x = f * state``) and
``x* = M* y`` (adjoint applied to the TL outputs), the test checks the
defining identity of the adjoint per column:

    norm1[col] = <Mx, Mx> = sum over the 10 TL outputs of sum_k y^2
    norm2[col] = <x, M*(Mx)> = sum over the 16 input pairs of sum_k x . x*

and passes iff ``max |norm1 - norm2| / (eps * norm2) < 1e4`` machine
epsilons.  The supersaturation increment is zeroed
(``ignore_supsat=True``, reference ``validation.py:116-122``).

The norm reductions are pure ``jnp`` (a per-column sum), so under a
column-sharded mesh they compile to a local reduction — no collective is
needed because the norms themselves stay per-column; only the final
``max`` over columns aggregates, which XLA lowers to a ``psum``-style
all-reduce over the mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics.adjoint import cloudsc2_ad
from cloudsc2_tpu.physics.increment import state_increment
from cloudsc2_tpu.physics.saturation import saturation
from cloudsc2_tpu.physics.tangent_linear import cloudsc2_tl

Array = jnp.ndarray

TEND_NAMES = ("t", "q", "ql", "qi")
DIAG_NAMES = ("clc", "fhpsl", "fhpsn", "fplsl", "fplsn", "covptot")
FIELD_PAIRS = (
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


@dataclass
class SymmetryTest:
    """Reference symmetry-test orchestration (``validation.py:44-231``).

    ``impl``: any of :data:`cloudsc2_tpu.dispatch.IMPLS`; "scan" (the
    default) runs on any platform and precision.
    """

    constants: Constants
    factor: float = 0.01
    kflag: int = 1
    lphylin: bool = True
    impl: str = "scan"
    #: optional column mesh: runs the TL/AD schemes column-sharded under
    #: ``shard_map`` (driver ``--sharded``); the per-column norms follow
    #: the output shardings (single-host addressable meshes)
    mesh: object = None
    _fns: tuple = None  # type: ignore[assignment]

    def _tl_ad(self, dtype):
        from cloudsc2_tpu.dispatch import scheme_fn

        if self._fns is None:
            fns = tuple(
                scheme_fn(s, self.impl, dtype, self.constants) for s in ("tl", "ad")
            )
            if self.mesh is not None:
                from cloudsc2_tpu.parallel.step import make_sharded_physics

                fns = tuple(make_sharded_physics(f, self.mesh) for f in fns)
            self._fns = fns
        return self._fns

    def run(self, state: Dict[str, Array], dt: float) -> Tuple[np.ndarray, np.ndarray]:
        from cloudsc2_tpu.utils.timing import device_sync, timing

        c = self.constants
        tl_fn, ad_fn = self._tl_ad(state["t"].dtype)
        state = dict(state)
        with timing("saturation"):
            state["qsat"] = device_sync(saturation(
                state["ap"], state["t"], kflag=self.kflag, lphylin=self.lphylin, c=c
            ))

        # x = f * state, with the supsat increment zeroed (reference
        # validation.py:116-122)
        with timing("state_increment"):
            incr = device_sync(state_increment(state, self.factor, ignore_supsat=True))
        state.update(incr)

        # y = M x
        with timing("cloudsc2_tl"):
            tends_tl, diags_tl = device_sync(tl_fn(state, dt, c))
        norm1 = self.get_norm1(tends_tl, diags_tl)

        # feed the TL outputs into the adjoint as cotangent seeds (reference
        # add_tendencies_to_state, validation.py:222-231)
        for name in TEND_NAMES:
            state["tnd_" + name] = tends_tl[name]
            state["tnd_" + name + "_i"] = tends_tl[name + "_i"]
        for name in DIAG_NAMES:
            state[name + "_i"] = diags_tl[name + "_i"]

        # x* = M* y
        with timing("cloudsc2_ad"):
            tends_ad, diags_ad = device_sync(ad_fn(state, dt, c))
        norm2 = self.get_norm2(incr, tends_ad, diags_ad)
        return np.asarray(norm1), np.asarray(norm2)

    @staticmethod
    def get_norm1(tends_tl: Dict[str, Array], diags_tl: Dict[str, Array]) -> Array:
        """Per-column <Mx, Mx> (reference ``validation.py:167-181``)."""
        out = 0.0
        for name in TEND_NAMES:
            out = out + jnp.sum(tends_tl[name + "_i"] ** 2, axis=0)
        for name in DIAG_NAMES:
            out = out + jnp.sum(diags_tl[name + "_i"] ** 2, axis=0)
        return out

    @staticmethod
    def get_norm2(
        incr: Dict[str, Array], tends_ad: Dict[str, Array], diags_ad: Dict[str, Array]
    ) -> Array:
        """Per-column <x, M*(Mx)> (reference ``validation.py:183-215``)."""
        out = 0.0
        for name in TEND_NAMES:
            out = out + jnp.sum(
                incr["tnd_cml_" + name + "_i"] * tends_ad["cml_" + name + "_i"], axis=0
            )
        for name in FIELD_PAIRS:
            out = out + jnp.sum(incr[name + "_i"] * diags_ad[name + "_i"], axis=0)
        return out

    def validate(
        self, norm1: np.ndarray, norm2: np.ndarray, verbose: bool = True
    ) -> float:
        """Maximum error in machine epsilons (reference ``validation.py:155-165``)."""
        eps = np.finfo(norm2.dtype).eps
        norm3 = np.where(
            norm2 == 0.0,
            np.abs(norm1 - norm2) / eps,
            np.abs(norm1 - norm2) / (eps * np.abs(norm2)),
        )
        err = float(norm3.max())
        if verbose:
            if err < 1e4:
                print("The symmetry test passed. HOORAY!")
            else:
                print("The symmetry test failed.")
            print(f"The maximum error is {err:.10e} times the machine epsilon.")
        return err

    def __call__(self, state: Dict[str, Array], dt: float, verbose: bool = True) -> float:
        norm1, norm2 = self.run(state, dt)
        return self.validate(norm1, norm2, verbose=verbose)
