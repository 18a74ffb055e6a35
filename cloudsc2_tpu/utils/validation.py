
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Field-wise validation of output dicts against reference data.

Rebuild of ``ifs_physics_common.utils.validation.validate`` as used by the
reference NL driver (``drivers/run_nonlinear.py:139-147``; contract in
SURVEY.md §2.2): per-field ``allclose`` comparison with a printed report,
returning the list of failing fields.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def validate(
    fields: Dict[str, np.ndarray],
    fields_ref: Dict[str, np.ndarray],
    *,
    atol: float = 1e-18,
    rtol: float = 1e-12,
    verbose: bool = True,
) -> List[str]:
    """Compare ``fields`` against ``fields_ref`` per field.

    Returns the names of fields that failed.  Fields present in only one of
    the two dicts are reported as failures.
    """
    failing: List[str] = []
    for name in sorted(set(fields) | set(fields_ref)):
        if name not in fields or name not in fields_ref:
            failing.append(name)
            if verbose:
                print(f"Validation of {name}: MISSING")
            continue
        a = np.asarray(fields[name])
        b = np.asarray(fields_ref[name])
        if a.shape != b.shape:
            failing.append(name)
            if verbose:
                print(f"Validation of {name}: SHAPE MISMATCH {a.shape} vs {b.shape}")
            continue
        ok = np.allclose(a, b, atol=atol, rtol=rtol, equal_nan=False)
        if not ok:
            failing.append(name)
        if verbose:
            err = np.abs(a.astype(np.float64) - b)
            # the smallest rtol that passes this field at the given atol
            # (allclose: err <= atol + rtol * |b|)
            with np.errstate(divide="ignore", invalid="ignore"):
                need = np.where(err > atol, (err - atol) / np.abs(b), 0.0)
            print(
                f"Validation of {name}: {'PASSED' if ok else 'FAILED'} "
                f"(max abs err {err.max() if err.size else 0.0:.3e}, "
                f"rtol needed at atol={atol:.1e}: "
                f"{need.max() if need.size else 0.0:.3e})"
            )
    return failing
