
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Data I/O and input synthesis for the CLOUDSC2 framework.

Re-implements the reference I/O layer (``src/cloudsc2_gt4py/iox.py:212-244``,
``setup.py:28-70``, ``physics/nonlinear/reference.py:28-55``) against plain
numpy:

* input files use the upstream ECMWF dwarf schema — per-field datasets laid
  out ``(KLEV, KLON)`` (or ``(5, KLEV, KLON)`` for the 5-species ``PCLV`` /
  ``TENDENCY_CML_CLD`` arrays, liquid at species 0 and ice at species 1,
  reference ``setup.py:56-62``), plus scalar datasets ``KLON``, ``KLEV``,
  ``PTSPHY`` and the namelist constants (``YRECLDP_*`` / ``YREPHLI_*``
  prefixes, reference ``iox.py:230-238``);
* the repository's own data files are ``.npz`` archives holding the same
  datasets under the same names; upstream HDF5 files (``.h5``) are read
  through ``h5py``, which is imported only for them (:func:`open_data`);
* fields are kept in the ``(nlev, ncols)`` layout (columns on the fast
  axis) — note the reference instead expands to an ``(I, J=1, K)`` GT4Py
  storage;
* since the upstream ``input.h5`` is a stripped blob in the mounted
  reference, :func:`synthesize_input` generates a physically plausible state
  with the exact same schema, so real upstream files remain drop-in.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Tuple

import numpy as np

from cloudsc2_tpu.grid import Grid
from cloudsc2_tpu.params import (
    YoethfParams,
    YomcstParams,
    YrecldpParams,
    YrephliParams,
    YrnclParams,
    YrphncParams,
    params_from_mapping,
)

#: input field name -> (h5 dataset, species index or None, staggered?)
INPUT_FIELDS: Dict[str, Tuple[str, int | None, bool]] = {
    "ap": ("PAP", None, False),
    "aph": ("PAPH", None, True),
    "lu": ("PLU", None, False),
    "lude": ("PLUDE", None, False),
    "mfd": ("PMFD", None, False),
    "mfu": ("PMFU", None, False),
    "q": ("PQ", None, False),
    "qi": ("PCLV", 1, False),
    "ql": ("PCLV", 0, False),
    "supsat": ("PSUPSAT", None, False),
    "t": ("PT", None, False),
    "tnd_cml_q": ("TENDENCY_CML_Q", None, False),
    "tnd_cml_qi": ("TENDENCY_CML_CLD", 1, False),
    "tnd_cml_ql": ("TENDENCY_CML_CLD", 0, False),
    "tnd_cml_t": ("TENDENCY_CML_T", None, False),
}

#: reference-output field name -> (h5 dataset, species index, staggered?)
REFERENCE_TENDENCIES = {
    "qi": ("TENDENCY_LOC_CLD", 1, False),
    "ql": ("TENDENCY_LOC_CLD", 0, False),
    "q": ("TENDENCY_LOC_Q", None, False),
    "t": ("TENDENCY_LOC_T", None, False),
}
REFERENCE_DIAGNOSTICS = {
    "clc": ("PCLC", None, False),
    "covptot": ("PCOVPTOT", None, False),
    "fhpsl": ("PFHPSL", None, True),
    "fhpsn": ("PFHPSN", None, True),
    "fplsl": ("PFPLSL", None, True),
    "fplsn": ("PFPLSN", None, True),
}


def _tile_columns(arr: np.ndarray, ncols: int) -> np.ndarray:
    """Select/tile the trailing column axis to ``ncols`` (cyclic repeat)."""
    n = arr.shape[-1]
    if ncols == n:
        return arr
    if ncols < n:
        return arr[..., :ncols]
    reps = -(-ncols // n)
    return np.tile(arr, (1,) * (arr.ndim - 1) + (reps,))[..., :ncols]


def _read_field(f: Any, name: str, species: int | None) -> np.ndarray:
    data = f[name][...]
    if species is not None:
        data = data[species]
    return np.asarray(data, dtype=np.float64)


@contextlib.contextmanager
def open_data(path: str) -> Iterator[Any]:
    """Open a data file as a mapping of dataset name to array: an ``.npz``
    archive through numpy, anything else as an upstream HDF5 file through
    ``h5py``."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            yield f
        return
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path} is read as an HDF5 file, which needs the h5py package "
            "(pip install h5py, or the project's 'hdf5' extra); the "
            "repository's own data files are .npz"
        ) from e
    with h5py.File(path, "r") as f:
        yield f


def read_state(
    f: Any, ncols: int | None = None, dtype: Any = np.float64
) -> Tuple[Grid, Dict[str, np.ndarray]]:
    """Read the 16 input fields from an open data file (:func:`open_data`)
    into ``(nlev, ncols)``."""
    nlev = int(f["KLEV"][0])
    nlon = int(f["KLON"][0])
    ncols = ncols or nlon
    grid = Grid(ncols=ncols, nlev=nlev)
    state: Dict[str, np.ndarray] = {}
    for name, (h5_name, species, _stag) in INPUT_FIELDS.items():
        arr = _tile_columns(_read_field(f, h5_name, species), ncols)
        state[name] = arr.astype(dtype)
    return grid, state


def read_params(f: Any) -> Dict[str, Any]:
    """Read the six namelist groups from an open data file."""
    scalars = {}
    for key in f.keys():
        ds = f[key]
        if getattr(ds, "shape", None) in ((), (1,)):
            scalars[key] = np.asarray(ds[...]).reshape(-1)[0]
    return {
        "yoethf": params_from_mapping(YoethfParams, scalars),
        "yomcst": params_from_mapping(YomcstParams, scalars),
        "yrecldp": params_from_mapping(YrecldpParams, scalars, prefix="YRECLDP_"),
        "yrephli": params_from_mapping(YrephliParams, scalars, prefix="YREPHLI_"),
        "yrncl": params_from_mapping(YrnclParams, scalars),
        "yrphnc": params_from_mapping(YrphncParams, scalars),
    }


def read_timestep(f: Any) -> float:
    """Physics timestep in seconds (reference ``iox.py:221-222``);
    0.0 when the dataset is absent."""
    ds = f.get("PTSPHY")
    if ds is None:
        return 0.0
    return float(np.asarray(ds[...]).reshape(-1)[0])


def read_reference(
    f: Any, ncols: int | None = None, dtype: Any = np.float64
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Read golden tendencies/diagnostics (reference ``reference.py:28-55``)."""
    nlon = int(f["KLON"][0])
    ncols = ncols or nlon
    tends = {
        name: _tile_columns(_read_field(f, h5, sp), ncols).astype(dtype)
        for name, (h5, sp, _s) in REFERENCE_TENDENCIES.items()
    }
    diags = {
        name: _tile_columns(_read_field(f, h5, sp), ncols).astype(dtype)
        for name, (h5, sp, _s) in REFERENCE_DIAGNOSTICS.items()
    }
    return tends, diags


# ---------------------------------------------------------------------------
# Input synthesis (the upstream input.h5 is a stripped blob in the mounted
# reference; see .MISSING_LARGE_BLOBS).
# ---------------------------------------------------------------------------

def synthesize_input(
    ncols: int = 100,
    nlev: int = 137,
    *,
    seed: int = 0,
    dt: float = 1800.0,
    dtype: Any = np.float64,
) -> Tuple[Grid, Dict[str, np.ndarray], float]:
    """Generate a physically plausible CLOUDSC2 input state.

    The profile has a warm surface, a cold tropopause around eta ~ 0.25 and a
    re-warming stratosphere (so the tropopause search of
    ``cloudsc2.py:106-111`` triggers), tropospheric humidity at 30-95 % RH,
    patchy liquid/ice cloud water, convective fluxes and small accumulated
    tendencies.  Values are deterministic given ``seed``.
    """
    rng = np.random.default_rng(seed)
    grid = Grid(ncols=ncols, nlev=nlev)

    ps = 101325.0 * (1.0 + 0.01 * rng.standard_normal(ncols))
    x = (np.arange(nlev + 1) / nlev)[:, None]
    aph = ps[None, :] * x**1.9
    ap = 0.5 * (aph[:-1] + aph[1:])
    eta_col = ap / aph[-1]

    t_surf = 288.0 + 10.0 * rng.standard_normal(ncols)
    t_trop = 216.5 + 4.0 * rng.standard_normal(ncols)
    eta_t = 0.25
    tropo = np.clip((eta_col - eta_t) / (1.0 - eta_t), 0.0, None)
    strato = np.clip((eta_t - eta_col) / eta_t, 0.0, None)
    t = t_trop[None, :] + (t_surf - t_trop)[None, :] * tropo**1.1 + 45.0 * strato**1.5
    t = t + 0.5 * rng.standard_normal((nlev, ncols))

    # saturation humidity with the IFS constants, for a plausible q
    y = YoethfParams()
    m = YomcstParams()
    alfa = np.minimum(1.0, ((np.clip(t, y.RTICE, y.RTWAT) - y.RTICE) * y.RTWAT_RTICE_R) ** 2)
    foeew = y.R2ES * (
        alfa * np.exp(y.R3LES * (t - m.RTT) / (t - y.R4LES))
        + (1.0 - alfa) * np.exp(y.R3IES * (t - m.RTT) / (t - y.R4IES))
    )
    qs = np.minimum(foeew / ap, 0.5)
    qsat = qs / (1.0 - m.RETV * qs)

    rh = np.clip(0.35 + 0.5 * rng.random((nlev, ncols)) + 0.2 * tropo, 0.0, 0.98)
    q = rh * qsat

    cloud_mask = (rng.random((nlev, ncols)) < 0.35) & (eta_col > 0.3) & (eta_col < 0.97)
    qc_tot = cloud_mask * rng.random((nlev, ncols)) * 3e-4
    fwat = np.clip((t - (m.RTT - 23.0)) / 23.0, 0.0, 1.0) ** 2
    ql = qc_tot * fwat
    qi = qc_tot * (1.0 - fwat)

    conv_mask = (rng.random((nlev, ncols)) < 0.4) & (eta_col > 0.4) & (eta_col < 0.95)
    lu = conv_mask * rng.random((nlev, ncols)) * 1e-4 + 1e-9
    lude = conv_mask * rng.random((nlev, ncols)) * 2e-5
    mfu = conv_mask * rng.random((nlev, ncols)) * 0.1
    mfd = conv_mask * rng.random((nlev, ncols)) * (-0.05)

    supsat = np.where(
        (t < m.RTT - 40.0) & (rng.random((nlev, ncols)) < 0.2),
        rng.random((nlev, ncols)) * 1e-5,
        0.0,
    )

    tnd_cml_t = 2e-5 * rng.standard_normal((nlev, ncols))
    tnd_cml_q = 1e-8 * rng.standard_normal((nlev, ncols))
    tnd_cml_ql = np.where(cloud_mask, 2e-9 * rng.standard_normal((nlev, ncols)), 0.0)
    tnd_cml_qi = np.where(cloud_mask, 2e-9 * rng.standard_normal((nlev, ncols)), 0.0)

    state = {
        "ap": ap,
        "aph": aph,
        "lu": lu,
        "lude": lude,
        "mfd": mfd,
        "mfu": mfu,
        "q": q,
        "qi": qi,
        "ql": ql,
        "supsat": supsat,
        "t": t,
        "tnd_cml_q": tnd_cml_q,
        "tnd_cml_qi": tnd_cml_qi,
        "tnd_cml_ql": tnd_cml_ql,
        "tnd_cml_t": tnd_cml_t,
    }
    state = {k: v.astype(dtype) for k, v in state.items()}
    return grid, state, dt


def write_input(
    path: str,
    state: Dict[str, np.ndarray],
    dt: float,
    params: Dict[str, Any] | None = None,
) -> None:
    """Write a state dict to an ``.npz`` archive in the upstream dwarf
    schema (dataset names and shapes as in the upstream ``input.h5``)."""
    nlev, ncols = state["ap"].shape
    data: Dict[str, np.ndarray] = {
        "KLEV": np.array([nlev], dtype=np.int64),
        "KLON": np.array([ncols], dtype=np.int64),
        "PTSPHY": np.array([dt], dtype=np.float64),
    }
    for name, (h5_name, species, _stag) in INPUT_FIELDS.items():
        if species is not None:
            data.setdefault(h5_name, np.zeros((5, nlev, ncols)))[species] = state[name]
        else:
            data[h5_name] = np.asarray(state[name], dtype=np.float64)
    # unused-but-in-schema cloud fraction field (reference setup.py:49)
    data["PA"] = np.zeros((nlev, ncols))
    groups = params or {
        "yoethf": YoethfParams(),
        "yomcst": YomcstParams(),
        "yrecldp": YrecldpParams(),
        "yrephli": YrephliParams(),
        "yrncl": YrnclParams(),
        "yrphnc": YrphncParams(),
    }
    prefixes = {"yrecldp": "YRECLDP_", "yrephli": "YREPHLI_"}
    for gname, group in groups.items():
        prefix = prefixes.get(gname, "")
        for field in dataclasses.fields(group):
            val = getattr(group, field.name)
            if isinstance(val, bool):
                arr = np.array([int(val)], dtype=np.int64)
            elif isinstance(val, int):
                arr = np.array([val], dtype=np.int64)
            else:
                arr = np.array([val], dtype=np.float64)
            data[prefix + field.name] = arr
    np.savez_compressed(path, **data)


def write_reference(
    path: str,
    tends: Dict[str, np.ndarray],
    diags: Dict[str, np.ndarray],
) -> None:
    """Write golden tendencies/diagnostics to an ``.npz`` archive in the
    reference output schema (datasets as in ``data/reference_double.h5``:
    ``TENDENCY_LOC_*``, ``PCLC``, ``PCOVPTOT``, ``PFHPSL/N``, ``PFPLSL/N``
    + ``KLON``/``KLEV``)."""
    nlev, ncols = tends["t"].shape
    data: Dict[str, np.ndarray] = {
        "KLEV": np.array([nlev], dtype=np.int64),
        "KLON": np.array([ncols], dtype=np.int64),
    }
    for name, (h5_name, species, _s) in REFERENCE_TENDENCIES.items():
        if species is not None:
            data.setdefault(h5_name, np.zeros((5, nlev, ncols)))[species] = tends[name]
        else:
            data[h5_name] = np.asarray(tends[name], dtype=np.float64)
    for name, (h5_name, _sp, _s) in REFERENCE_DIAGNOSTICS.items():
        data[h5_name] = np.asarray(diags[name], dtype=np.float64)
    np.savez_compressed(path, **data)


def load_input(
    path: str, ncols: int | None = None, dtype: Any = np.float64
) -> Tuple[Grid, Dict[str, np.ndarray], float, Dict[str, Any]]:
    """Load grid, state, timestep and parameter groups from an input file."""
    with open_data(path) as f:
        grid, state = read_state(f, ncols, dtype)
        dt = read_timestep(f)
        params = read_params(f)
    return grid, state, dt, params


def load_reference(
    path: str, ncols: int | None = None, dtype: Any = np.float64
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Load golden tendencies/diagnostics from a reference file."""
    with open_data(path) as f:
        return read_reference(f, ncols, dtype)
