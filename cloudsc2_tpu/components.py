
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Sympl-style component layer over the functional kernels.

Rebuild of the ``ifs_physics_common.framework.components`` contract
(SURVEY.md §2.2; reference usage ``physics/common/saturation.py:33-76``,
``physics/nonlinear/microphysics.py:43-172``): components declare
``input_properties`` / ``tendency_properties`` / ``diagnostic_properties``
(name → ``{dims, units}``) and are callable on state dicts.  Unlike the
reference (mutable GT4Py storages, preallocated ``out=`` dicts), these are
thin declarative wrappers over pure jitted functions — outputs are fresh
``jax.Array``s and XLA handles buffer reuse (donation) itself.

Dims use the column-fast layout: ``("levels", "columns")`` for full-level
fields, ``("levels+1", "columns")`` for interface fields, ``("levels",)``
for the eta coordinate.  Field names drop the reference's ``f_`` prefix.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import jax.numpy as jnp

from cloudsc2_tpu.grid import Grid
from cloudsc2_tpu.params import Constants
from cloudsc2_tpu.physics import diagnostics as _diagnostics
from cloudsc2_tpu.physics import increment as _increment
from cloudsc2_tpu.physics.saturation import saturation as _saturation

Array = jnp.ndarray
PropertyDict = Dict[str, Dict[str, Any]]

FULL = ("levels", "columns")
IFACE = ("levels+1", "columns")
VERT = ("levels",)

#: units per field (reference ``nonlinear/microphysics.py:80-121``,
#: ``setup.py:48-65``)
UNITS = {
    "ap": "Pa",
    "aph": "Pa",
    "eta": "",
    "lu": "g g^-1",
    "lude": "kg m^-3 s^-1",
    "mfd": "kg m^-2 s^-1",
    "mfu": "kg m^-2 s^-1",
    "q": "g g^-1",
    "qi": "g g^-1",
    "ql": "g g^-1",
    "qsat": "g g^-1",
    "supsat": "g g^-1",
    "t": "K",
    "tnd_cml_q": "g g^-1 s^-1",
    "tnd_cml_qi": "g g^-1 s^-1",
    "tnd_cml_ql": "g g^-1 s^-1",
    "tnd_cml_t": "K s^-1",
    "clc": "",
    "covptot": "",
    "fhpsl": "J m^-2 s^-1",
    "fhpsn": "J m^-2 s^-1",
    "fplsl": "kg m^-2 s^-1",
    "fplsn": "kg m^-2 s^-1",
}

TEND_UNITS = {
    "t": "K s^-1",
    "q": "g g^-1 s^-1",
    "ql": "g g^-1 s^-1",
    "qi": "g g^-1 s^-1",
}


def _props(names: Mapping[str, Tuple[str, ...]]) -> PropertyDict:
    return {
        n: {"dims": d, "units": UNITS.get(n[:-2] if n.endswith("_i") else n, "")}
        for n, d in names.items()
    }


class Component:
    """Base: property declaration + optional shape/name checking.

    Every subclass ``__call__`` is wrapped in a
    :func:`~cloudsc2_tpu.utils.timing.timing` block labeled by the
    component's snake-case name (``cloudsc2_nl``, ``saturation``, ...) — the
    analogue of the reference's per-stencil ``exec_info`` timings threaded
    into every stencil call (``physics/common/saturation.py:75``); the
    labels feed ``write_stencils_performance_to_csv``.

    The wrapper device-syncs the outputs before closing the timing block
    (JAX dispatch is asynchronous: without the sync the label would record
    dispatch, not execution — the reference's ``exec_info`` measures actual
    stencil execution, ``run_nonlinear.py:221-232``).  Set
    ``sync_timings = False`` on a class or instance to opt out (e.g. to
    pipeline component calls inside a larger timed region).
    """

    input_properties: PropertyDict = {}
    diagnostic_properties: PropertyDict = {}
    tendency_properties: PropertyDict = {}
    name: str = ""
    #: sync outputs inside the timing block so labels measure execution
    sync_timings: bool = True

    def __init_subclass__(cls, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        if "__call__" in cls.__dict__:
            import functools
            import re

            from cloudsc2_tpu.utils import timing as _timing

            inner = cls.__dict__["__call__"]
            cls.name = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", cls.__name__).lower()

            @functools.wraps(inner)
            def timed(self, *a: Any, **k: Any):
                with _timing.timing(self.name):
                    out = inner(self, *a, **k)
                    if self.sync_timings:
                        # late-bound module attribute so tests can observe
                        # the sync and callers can monkeypatch the policy
                        _timing.device_sync(out)
                return out

            cls.__call__ = timed

    def __init__(
        self,
        grid: Grid,
        constants: Constants,
        *,
        enable_checks: bool = False,
        dtype: Any = None,
    ):
        self.grid = grid
        self.constants = constants
        self.enable_checks = enable_checks
        #: expected floating dtype under checks; None enforces uniformity only
        self.dtype = dtype

    def _check_state(self, state: Mapping[str, Array]) -> Dict[str, Array]:
        """Validate and normalize the declared inputs; returns the state to
        compute on.

        Unit-tagged values (:class:`cloudsc2_tpu.units.UnitArray`, or any
        object with ``.data`` and ``.units``) are always converted to the
        declared property units and stripped — the sympl strip/convert
        behavior the reference components inherit (SURVEY.md §2.2) —
        raising :class:`~cloudsc2_tpu.units.UnitsError` on dimension
        mismatch.  With ``enable_checks``, shapes are validated against the
        grid and dtypes must be floating and uniform (and equal to
        ``self.dtype`` when set).
        """
        from cloudsc2_tpu.units import strip_units

        out = dict(state)
        shapes = {
            FULL: self.grid.full_shape,
            IFACE: self.grid.iface_shape,
            VERT: (self.grid.nlev,),
        }
        expected_dtype = self.dtype
        for name, prop in self.input_properties.items():
            if name not in out:
                raise KeyError(f"{type(self).__name__}: missing input field {name!r}")
            v = out[name] = strip_units(out[name], prop["units"])
            if not self.enable_checks:
                continue
            want = shapes[prop["dims"]]
            got = tuple(v.shape)
            if got != want:
                raise ValueError(
                    f"{type(self).__name__}: field {name!r} has shape {got}, want {want}"
                )
            dt = jnp.asarray(v).dtype
            if not jnp.issubdtype(dt, jnp.floating):
                raise TypeError(
                    f"{type(self).__name__}: field {name!r} has non-floating dtype {dt}"
                )
            if expected_dtype is None:
                expected_dtype = dt
            elif dt != jnp.dtype(expected_dtype):
                raise TypeError(
                    f"{type(self).__name__}: field {name!r} has dtype {dt}, "
                    f"want {jnp.dtype(expected_dtype)}"
                )
        return out


class EtaLevels(Component):
    """Diagnoses the reference eta coordinate
    (reference ``physics/common/diagnostics.py:28-45``)."""

    input_properties = _props({"ap": FULL, "aph": IFACE})
    diagnostic_properties = _props({"eta": VERT})

    def __call__(self, state: Dict[str, Array]) -> Dict[str, Array]:
        state = self._check_state(state)
        return {"eta": _diagnostics.eta_levels(state["ap"], state["aph"])}


class Saturation(Component):
    """Diagnoses ``qsat`` (reference ``physics/common/saturation.py:33-76``)."""

    input_properties = _props({"ap": FULL, "t": FULL})
    diagnostic_properties = _props({"qsat": FULL})

    def __init__(self, grid, constants, *, kflag: int = 1, lphylin: bool = True, **kw):
        super().__init__(grid, constants, **kw)
        self.kflag = kflag
        self.lphylin = lphylin

    def __call__(self, state: Dict[str, Array]) -> Dict[str, Array]:
        state = self._check_state(state)
        qsat = _saturation(
            state["ap"], state["t"], kflag=self.kflag, lphylin=self.lphylin, c=self.constants
        )
        return {"qsat": qsat}


class StateIncrement(Component):
    """Produces the 16-field perturbation ``*_i = f * field``
    (reference ``physics/common/increment.py:32-132``)."""

    input_properties = _props({n: (IFACE if n == "aph" else FULL) for n in _increment.INCREMENT_FIELDS})
    diagnostic_properties = _props(
        {n + "_i": (IFACE if n == "aph" else FULL) for n in _increment.INCREMENT_FIELDS}
    )

    def __init__(self, grid, constants, factor: float, *, ignore_supsat: bool = False, **kw):
        super().__init__(grid, constants, **kw)
        self.factor = factor
        self.ignore_supsat = ignore_supsat

    def __call__(self, state: Dict[str, Array]) -> Dict[str, Array]:
        state = self._check_state(state)
        return _increment.state_increment(state, self.factor, ignore_supsat=self.ignore_supsat)


class PerturbedState(Component):
    """Produces ``field + f * field_i`` (reference
    ``physics/common/increment.py:135-261``)."""

    input_properties = _props(
        {
            **{n: (IFACE if n == "aph" else FULL) for n in _increment.INCREMENT_FIELDS},
            **{n + "_i": (IFACE if n == "aph" else FULL) for n in _increment.INCREMENT_FIELDS},
        }
    )
    diagnostic_properties = _props({n: (IFACE if n == "aph" else FULL) for n in _increment.INCREMENT_FIELDS})

    def __init__(self, grid, constants, factor: float, **kw):
        super().__init__(grid, constants, **kw)
        self.factor = factor

    def __call__(self, state: Dict[str, Array]) -> Dict[str, Array]:
        state = self._check_state(state)
        return _increment.perturbed_state(state, self.factor)


_NL_INPUTS = {
    "ap": FULL, "aph": IFACE, "eta": VERT, "lu": FULL, "lude": FULL,
    "mfd": FULL, "mfu": FULL, "q": FULL, "qi": FULL, "ql": FULL,
    "qsat": FULL, "supsat": FULL, "t": FULL, "tnd_cml_q": FULL,
    "tnd_cml_qi": FULL, "tnd_cml_ql": FULL, "tnd_cml_t": FULL,
}
_NL_DIAGS = {
    "clc": FULL, "covptot": FULL, "fhpsl": IFACE, "fhpsn": IFACE,
    "fplsl": IFACE, "fplsn": IFACE,
}


def _run_scheme(comp: "Component", scheme: str, state, timestep: float):
    """Run ``scheme`` through the single dispatch home
    (:func:`cloudsc2_tpu.dispatch.scheme_fn`), so every ``impl`` resolves
    identically here, in the step functions and in the protocols."""
    from cloudsc2_tpu.dispatch import scheme_fn

    fn = scheme_fn(scheme, comp.impl, state["ap"].dtype, comp.constants)
    return fn(state, timestep, comp.constants)


class Cloudsc2NL(Component):
    """Nonlinear CLOUDSC2 (reference
    ``physics/nonlinear/microphysics.py:43-172``): 17 inputs, 4 tendencies,
    6 diagnostics.  ``impl``: "auto" (the GPU kernel on a GPU in f32) |
    "scan" | "pallas" | "pallas-interpret" (see :mod:`cloudsc2_tpu.dispatch`)."""

    input_properties = _props(_NL_INPUTS)
    tendency_properties = {n: {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()}
    diagnostic_properties = _props(_NL_DIAGS)

    def __init__(self, grid, constants, *, impl: str = "auto", **kw):
        super().__init__(grid, constants, **kw)
        self.impl = impl

    def __call__(
        self, state: Dict[str, Array], timestep: float
    ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
        return _run_scheme(self, "nl", self._check_state(state), timestep)


class Cloudsc2TL(Component):
    """Tangent-linear CLOUDSC2 (reference
    ``physics/tangent_linear/microphysics.py:46-242``): every field paired
    with its ``*_i`` perturbation."""

    input_properties = _props(
        {**_NL_INPUTS, **{n + "_i": (IFACE if n == "aph" else FULL) for n in _increment.INCREMENT_FIELDS}}
    )
    tendency_properties = {
        **{n: {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()},
        **{n + "_i": {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()},
    }
    diagnostic_properties = _props(
        {**_NL_DIAGS, **{n + "_i": d for n, d in _NL_DIAGS.items()}}
    )

    def __init__(self, grid, constants, *, impl: str = "auto", **kw):
        super().__init__(grid, constants, **kw)
        self.impl = impl

    def __call__(
        self, state: Dict[str, Array], timestep: float
    ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
        return _run_scheme(self, "tl", self._check_state(state), timestep)


class Cloudsc2AD(Component):
    """Adjoint CLOUDSC2 (reference ``physics/adjoint/microphysics.py:46-238``):
    nonlinear trajectory + output-side cotangents in, forward tendencies +
    input-side cotangents out.

    The GPU kernel (:func:`cloudsc2_tpu.pallas.adjoint.cloudsc2_ad_pallas`)
    needs ``LPHYLIN=True``: its forward sweep is the NL kernel, whose
    trajectory coincides with the TL forward only under linearized
    physics.  ``impl="auto"`` runs the scan adjoint otherwise, and an
    explicit kernel ``impl`` raises.
    """

    input_properties = _props(
        {
            **_NL_INPUTS,
            **{"tnd_" + n: FULL for n in ("t", "q", "ql", "qi")},
            **{"tnd_" + n + "_i": FULL for n in ("t", "q", "ql", "qi")},
            **{n + "_i": d for n, d in _NL_DIAGS.items()},
        }
    )
    tendency_properties = {
        **{n: {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()},
        **{"cml_" + n + "_i": {"dims": FULL, "units": u} for n, u in TEND_UNITS.items()},
    }
    diagnostic_properties = _props(
        {
            **_NL_DIAGS,
            **{
                n + "_i": (IFACE if n == "aph" else FULL)
                for n in (
                    "ap", "aph", "t", "q", "qsat", "ql", "qi", "lu", "lude",
                    "mfd", "mfu", "supsat",
                )
            },
        }
    )

    def __init__(self, grid, constants, *, impl: str = "auto", **kw):
        super().__init__(grid, constants, **kw)
        self.impl = impl

    def __call__(
        self, state: Dict[str, Array], timestep: float
    ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
        return _run_scheme(self, "ad", self._check_state(state), timestep)
