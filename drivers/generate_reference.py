# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Generate golden data for the synthetic workload.

The upstream ``data/input.h5`` is a stripped blob in the mounted reference
(SURVEY.md §0), so its golden outputs (``reference_{double,single}.h5``)
cannot be reproduced bit-for-bit — they correspond to inputs we do not
have.  This script regenerates the *capability*: a deterministic synthetic
input (``data/input_synth.npz``, upstream schema and dataset names) and
per-precision golden outputs computed by the **independent scalar NumPy
oracle** (:mod:`cloudsc2_tpu.oracle` — shares no code with the JAX path),
in the reference output schema.

Usage:  python drivers/generate_reference.py [--ncols 100] [--nlev 137]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate the synthetic golden data.")
    ap.add_argument("--ncols", type=int, default=100)
    ap.add_argument("--nlev", type=int, default=137)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from cloudsc2_tpu import iox, make_constants
    from cloudsc2_tpu.oracle import oracle_nonlinear, oracle_saturation

    os.makedirs(DATA_DIR, exist_ok=True)
    grid, state, dt = iox.synthesize_input(ncols=args.ncols, nlev=args.nlev, seed=args.seed)
    iox.write_input(os.path.join(DATA_DIR, "input_synth.npz"), state, dt)
    print(f"wrote data/input_synth.npz ({args.ncols} cols x {args.nlev} levels, dt={dt})")

    c = make_constants(lphylin=True, ldrain1d=False)
    for precision, dtype in (("double", np.float64), ("single", np.float32)):
        s = {k: v.astype(dtype) for k, v in state.items()}
        s["eta"] = (s["ap"][:, 0] / s["aph"][-1, 0]).astype(dtype)
        s["qsat"] = oracle_saturation(s["ap"], s["t"], c).astype(dtype)
        tends, diags = oracle_nonlinear(s, dt, c)
        path = os.path.join(DATA_DIR, f"reference_synth_{precision}.npz")
        iox.write_reference(path, tends, diags)
        print(f"wrote {os.path.relpath(path, os.path.dirname(DATA_DIR))}")


if __name__ == "__main__":
    main()
