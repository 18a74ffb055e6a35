# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Smoke test of the main path on a GPU: the quickest proof that the system
still starts and is right on the card.

    python chip_smoke.py            # one card, phases 1-5
    python chip_smoke.py --multi    # four cards: the sharded phase only

Phases (one card), all through the normal entry points — the drivers'
``main`` functions and components -> ``dispatch`` with ``impl="auto"``:

1. NL f32 at 65,536 columns against the synthetic single-precision goldens.
2. NL f64 at 4,096 columns against the double-precision goldens.
3. Each GPU kernel against its ``lax.scan`` path at 65,536 columns, f32.
4. Taylor test: f64 on the reference's single column; f32 through the TL
   kernel at 4,096 columns, on the single-column protocol and per column
   (the strict fraction).
5. Symmetry test at 65,536 columns f32 and 4,096 columns f64.

``--multi`` runs the NL golden validation sharded over four cards and the
sharded ``full_step`` symmetry, each compared per column with one card.

Every phase prints what ran, its errors against its tolerance and its
seconds; a failed phase makes the exit code non-zero.  The last line of
standard output is one JSON object naming the device.  Without a GPU the
script exits non-zero before any phase and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

#: kernel against scan, per output field, as the error over the field's
#: largest magnitude.  Both paths run the same level bodies in f32; what
#: differs is XLA's fusion and FMA contraction against the kernel's, a few
#: ulps per level.  The largest seen on the H100 is 6.7e-5 (AD ``lu_i``:
#: the derivative of the detrainment exponential exp(-lude/lu) scales with
#: 1/lu^2, lu reaches 1e-9, and that amplifies the rounding); every other
#: field stays below 1e-6.  A wrong kernel is off by O(1).
KERNEL_TOL = 1e-3
NCOLS = 65536


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


class Phases:
    """Runs the phases, prints a summary line for each, and keeps each
    phase's full output under ``chiprun_out/``."""

    def __init__(self):
        self.failed = []
        self.out_dir = os.path.join(REPO, "chiprun_out")
        os.makedirs(self.out_dir, exist_ok=True)

    def run(self, name, fn):
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                ok, summary = fn()
        except Exception as e:  # noqa: BLE001 — a phase's failure is reported, never hidden
            import traceback

            buf.write(traceback.format_exc())
            ok, summary = False, f"raised {type(e).__name__}: {e}"
        secs = time.perf_counter() - t0
        with open(os.path.join(self.out_dir, f"chip_smoke_{name}.log"), "w") as f:
            f.write(buf.getvalue())
        print(f"[{name}] {'ok' if ok else 'FAILED'} in {secs:.1f} s: {summary}", flush=True)
        if not ok:
            self.failed.append(name)
            print(buf.getvalue()[-4000:], flush=True)
        return buf.getvalue()


def _lines(text, *keys):
    return "; ".join(ln.strip() for ln in text.splitlines() if any(k in ln for k in keys))


def _driver(module, argv):
    """Run a driver's ``main(argv)`` in this process; ``(rc, stdout)``."""
    import importlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(module).main(argv)
    text = buf.getvalue()
    print(text)
    return rc, text


def _impl_note(scheme, dtype):
    from cloudsc2_tpu import make_constants
    from cloudsc2_tpu.dispatch import use_kernel

    c = make_constants(lphylin=True, ldrain1d=False)
    return "kernel" if use_kernel("auto", scheme, dtype, c) else "scan"


def phase_nl(precision, ncols):
    import numpy as np

    from drivers.run_nonlinear import TOLERANCES

    def run():
        rc, text = _driver("drivers.run_nonlinear", [
            "--precision", precision, "--num-cols", str(ncols),
        ])
        dtype = np.float32 if precision == "single" else np.float64
        tol = TOLERANCES[precision]
        ok = rc == 0 and "HOORAY" in text
        return ok, (
            f"NL {precision} {ncols} cols ran {_impl_note('nl', dtype)}; "
            f"tolerance (atol, rtol) = {tol}; "
            + _lines(text, "Validation of", "Performance")
        )

    return run


def phase_kernels():
    import jax
    import numpy as np

    from cloudsc2_tpu import make_constants
    from cloudsc2_tpu.dispatch import KERNEL_SCHEMES, scheme_fns
    from cloudsc2_tpu.validation.kernels import field_errors, scheme_state

    def run():
        c = make_constants(lphylin=True, ldrain1d=False)
        parts, ok = [], True
        for scheme in KERNEL_SCHEMES:
            state, dt = scheme_state(scheme, NCOLS, np.float32, c)
            scan, kernel = scheme_fns(scheme)
            errs = field_errors(
                jax.block_until_ready(scan(state, dt, c)),
                jax.block_until_ready(kernel(state, dt, c)),
            )
            print(scheme, json.dumps(errs))
            worst = max(errs, key=lambda n: errs[n][1])
            ok = ok and errs[worst][1] <= KERNEL_TOL
            parts.append(
                f"{scheme.upper()} kernel vs scan worst {worst}: max abs "
                f"{errs[worst][0]:.3e}, rel to field max {errs[worst][1]:.3e}"
            )
        return ok, f"{NCOLS} cols f32, tolerance {KERNEL_TOL:g}; " + "; ".join(parts)

    return run


def phase_taylor():
    def run():
        runs = [
            ("f64, the reference's single-column protocol", []),
            ("f32 TL kernel, single-column protocol, 4096 cols", [
                "--precision", "single", "--num-cols", "4096", "--impl", "pallas",
                "--floors", "auto", "--tile-column",
            ]),
            ("f32 TL kernel per column, 4096 cols", [
                "--precision", "single", "--num-cols", "4096", "--impl", "pallas",
                "--floors", "auto", "--per-column",
            ]),
        ]
        ok, parts = True, []
        for label, argv in runs:
            rc, text = _driver("drivers.run_taylor_test", argv)
            ok = ok and rc == 0 and "HOORAY" in text
            parts.append(f"{label}: rc {rc}; " + _lines(
                text, "passed with penalty", "failed with error",
                "columns passing individually", "STRICT",
            ))
        return ok, " | ".join(parts)

    return run


def phase_symmetry():
    import numpy as np

    def run():
        runs = [
            ("f32 65536 cols (auto)", ["--precision", "single", "--num-cols", str(NCOLS),
                                       "--impl", "auto"]),
            ("f64 4096 cols", ["--num-cols", "4096", "--impl", "auto"]),
        ]
        ok, parts = True, []
        for label, argv in runs:
            rc, text = _driver("drivers.run_symmetry_test", argv)
            ok = ok and rc == 0 and "HOORAY" in text
            dtype = np.float32 if "single" in argv else np.float64
            parts.append(
                f"{label}: TL {_impl_note('tl', dtype)}, AD {_impl_note('ad', dtype)}; "
                f"rc {rc}; limit 1e4 eps; " + _lines(text, "maximum error")
            )
        return ok, " | ".join(parts)

    return run


def phase_multi():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cloudsc2_tpu import iox, make_constants
    from cloudsc2_tpu.parallel.mesh import column_mesh, shard_state
    from cloudsc2_tpu.parallel.step import (
        forward_step,
        full_step,
        make_sharded_fn,
        make_sharded_forward_step,
    )
    from cloudsc2_tpu.physics.diagnostics import eta_levels
    from cloudsc2_tpu.validation.kernels import field_errors
    from drivers.config import default_input_file

    def run():
        rc, text = _driver("drivers.run_nonlinear", [
            "--precision", "single", "--num-cols", str(NCOLS), "--sharded",
        ])
        ok = rc == 0 and "HOORAY" in text
        parts = [f"sharded NL golden validation on 4 cards: rc {rc}"]

        _, state_np, dt, params = iox.load_input(
            default_input_file(), ncols=NCOLS, dtype=np.float32
        )
        c = make_constants(lphylin=True, ldrain1d=False, **params)
        one = {k: jnp.asarray(v, jnp.float32) for k, v in state_np.items()}
        one["eta"] = eta_levels(one["ap"], one["aph"])
        mesh = column_mesh(4)
        sharded = shard_state(dict(one), mesh)

        nl_4 = make_sharded_forward_step(mesh, dt=dt, c=c)(sharded)
        nl_1 = jax.jit(lambda s: forward_step(s, dt, c))(one)
        errs = field_errors(nl_1, nl_4)
        worst = max(errs, key=lambda n: errs[n][1])
        ok = ok and errs[worst][1] <= 1e-6
        parts.append(
            f"sharded NL ({_impl_note('nl', np.float32)} under shard_map) vs one "
            f"card: worst {worst} max abs {errs[worst][0]:.3e}, rel to field max "
            f"{errs[worst][1]:.3e} (limit 1e-6)"
        )

        _, n1_4, n2_4 = make_sharded_fn(full_step, mesh, sharded, dt=dt, c=c)(sharded)
        _, n1_1, n2_1 = jax.jit(lambda s: full_step(s, dt, c))(one)
        n1_4, n2_4 = np.asarray(n1_4, np.float64), np.asarray(n2_4, np.float64)
        eps = np.finfo(np.float32).eps
        err = float((np.abs(n1_4 - n2_4) / (eps * np.abs(n2_4))).max())
        rel = float(max(
            np.abs(n1_4 - np.asarray(n1_1)).max() / np.abs(n1_4).max(),
            np.abs(n2_4 - np.asarray(n2_1)).max() / np.abs(n2_4).max(),
        ))
        ok = ok and err < 1e4 and rel < 1e-5
        parts.append(
            f"sharded full_step symmetry: max error {err:.3f} eps (limit 1e4); "
            f"per-column norms vs one card: max rel diff {rel:.3e} (limit 1e-5)"
        )
        return ok, "; ".join(parts)

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true", help="four-card phase only")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX runs on {devices[0].platform!r})", file=sys.stderr)
        return 2
    need = 4 if args.multi else 1
    if len(devices) < need:
        print(f"chip_smoke: {need} GPUs needed, {len(devices)} found", file=sys.stderr)
        return 2

    from cloudsc2_tpu.config import enable_compile_cache

    cache = enable_compile_cache()
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"{len(devices)} device(s); compile cache {cache}", flush=True)

    phases = Phases()
    if args.multi:
        phases.run("multi", phase_multi())
    else:
        phases.run("nl_f32", phase_nl("single", NCOLS))
        phases.run("nl_f64", phase_nl("double", 4096))
        phases.run("kernels", phase_kernels())
        phases.run("taylor", phase_taylor())
        phases.run("symmetry", phase_symmetry())
    stats = [d.memory_stats() or {} for d in devices[:need]]
    print("peak_bytes_in_use: " + ", ".join(str(s.get("peak_bytes_in_use")) for s in stats))
    if phases.failed:
        print(f"chip_smoke: failed phases: {phases.failed}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": devices[0].platform, "kind": devices[0].device_kind,
                   "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
