
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Minimal unit algebra for component I/O validation and conversion.

The reference validates and converts physical units on every component call
(sympl DataArrays carry pint units; the external ``ImplicitTendencyComponent``
strips/converts them against the declared property dicts — SURVEY.md §2.2
components row, reference usage ``physics/common/saturation.py:33-76``).
This module is the equivalent here, sized to the unit set the scheme
actually uses (SI mass/length/time/temperature products): a parser from unit
strings like ``"kg m^-2 s^-1"`` to a (scale, dimension-exponents) pair, a
:func:`convert` helper, and the :class:`UnitArray` carrier components accept
in place of raw arrays.

Unit strings are whitespace-separated ``atom`` or ``atom^int`` factors
(the format of the reference's property dicts, e.g. ``"g g^-1"``,
``"J m^-2 s^-1"``); the empty string (or ``"1"``) is dimensionless.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Mapping, NamedTuple, Tuple


class UnitsError(ValueError):
    """Raised for unparseable or dimensionally incompatible units."""


#: atom -> (scale to SI, exponents over (kg, m, s, K))
_ATOMS: Dict[str, Tuple[float, Tuple[int, int, int, int]]] = {
    "kg": (1.0, (1, 0, 0, 0)),
    "g": (1e-3, (1, 0, 0, 0)),
    "m": (1.0, (0, 1, 0, 0)),
    "km": (1e3, (0, 1, 0, 0)),
    "cm": (1e-2, (0, 1, 0, 0)),
    "s": (1.0, (0, 0, 1, 0)),
    "h": (3600.0, (0, 0, 1, 0)),
    "K": (1.0, (0, 0, 0, 1)),
    "Pa": (1.0, (1, -1, -2, 0)),
    "hPa": (1e2, (1, -1, -2, 0)),
    "J": (1.0, (1, 2, -2, 0)),
    "W": (1.0, (1, 2, -3, 0)),
    "1": (1.0, (0, 0, 0, 0)),
}


@lru_cache(maxsize=None)
def parse(units: str) -> Tuple[float, Tuple[int, int, int, int]]:
    """Parse a unit string into ``(scale_to_SI, dimension_exponents)``."""
    scale = 1.0
    dims = [0, 0, 0, 0]
    for factor in units.split():
        atom, _, exp_s = factor.partition("^")
        if atom not in _ATOMS:
            raise UnitsError(f"unknown unit atom {atom!r} in {units!r}")
        try:
            exp = int(exp_s) if exp_s else 1
        except ValueError:
            raise UnitsError(f"bad exponent {exp_s!r} in {units!r}") from None
        ascale, adims = _ATOMS[atom]
        scale *= ascale**exp
        dims = [d + a * exp for d, a in zip(dims, adims)]
    return scale, tuple(dims)  # type: ignore[return-value]


def convert(value: Any, from_units: str, to_units: str) -> Any:
    """Convert ``value`` between unit strings; raises :class:`UnitsError`
    when the dimensions differ.  Exact no-op when the scales match (so
    ``"g g^-1"`` vs ``"kg kg^-1"`` costs nothing)."""
    f_scale, f_dims = parse(from_units)
    t_scale, t_dims = parse(to_units)
    if f_dims != t_dims:
        raise UnitsError(
            f"incompatible units: {from_units!r} (dims {f_dims}) cannot be "
            f"converted to {to_units!r} (dims {t_dims})"
        )
    factor = f_scale / t_scale
    if factor == 1.0:
        return value
    if hasattr(value, "dtype"):
        # keep the array dtype (a python-float factor would upcast f32 numpy)
        return value * value.dtype.type(factor)
    return value * factor


class UnitArray(NamedTuple):
    """An array tagged with its units — the sympl-DataArray analogue.

    Components accept these anywhere a raw array is accepted and convert
    them to the declared property units before computing (raising
    :class:`UnitsError` on dimension mismatch); any object exposing
    ``.data`` and ``.units`` (e.g. an xarray DataArray with a ``units``
    accessor) is treated the same way.
    """

    data: Any
    units: str


def strip_units(value: Any, to_units: str) -> Any:
    """Convert a unit-tagged value to ``to_units`` and return the raw data;
    raw (untagged) values pass through unchanged (the fast path — units
    are then the caller's responsibility, as with raw numpy in sympl)."""
    units = getattr(value, "units", None)
    data = getattr(value, "data", None)
    if units is None or data is None:
        return value
    return convert(data, str(units), to_units)


def convert_state(
    state: Mapping[str, Any], from_units: Mapping[str, str], to_units: Mapping[str, str]
) -> Dict[str, Any]:
    """Convert every field named in ``from_units`` to its ``to_units`` entry
    (the iox-boundary helper: load raw arrays in file units, convert once)."""
    out = dict(state)
    for name, units in from_units.items():
        if name in out and name in to_units:
            out[name] = convert(out[name], units, to_units[name])
    return out
