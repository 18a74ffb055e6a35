# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Each scheme's GPU level-scan kernel against its ``lax.scan`` path, on
the card, at the benchmark shape (65,536 columns x 137 levels, float32).

    python benchmarks/kernel_vs_scan.py --check
        compile each kernel and its scan once, compare them per output
        field, print the kernel's ``memory_analysis()`` and stop
    python benchmarks/kernel_vs_scan.py [--configs 128x4,64x2,...]
        time scan and kernel in turns (scan, kernel, kernel, scan), each
        turn the median of ``--reps`` runs of host time around
        ``block_until_ready``; every ``--configs`` entry (columns per block
        x warps) is one kernel variant

One JSON object per line goes to stdout and to
``chiprun_out/kernel_vs_scan.jsonl``.  A kernel is kept for a scheme only
if it beats that scheme's scan end to end.  It refuses to run without a
GPU unless ``--interpret`` asks for the kernels' interpret mode (a CPU
rehearsal of the control flow; its times are not device times).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--schemes", default="nl,tl,ad")
    ap.add_argument("--ncols", type=int, default=65536)
    ap.add_argument("--configs", default="", help="block_cols x num_warps list")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--interpret", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    from chip_smoke import card_line
    from cloudsc2_tpu import make_constants
    from cloudsc2_tpu.config import enable_compile_cache
    from cloudsc2_tpu.dispatch import scheme_fns
    from cloudsc2_tpu.validation.kernels import field_errors, scheme_state

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.interpret:
        print(f"no GPU: JAX runs on {dev.platform!r}", file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    os.makedirs("chiprun_out", exist_ok=True)

    def emit(rec):
        line = json.dumps({"device_kind": dev.device_kind, "card": card_name, **rec})
        print(line, flush=True)
        with open(os.path.join("chiprun_out", "kernel_vs_scan.jsonl"), "a") as log:
            log.write(line + "\n")

    card_name = card_line()
    print(f"card: {card_name}; jax {jax.__version__}; {dev.device_kind}; cache {cache}")
    c = make_constants(lphylin=True, ldrain1d=False)
    configs = [
        tuple(int(v) for v in s.split("x")) for s in args.configs.split(",") if s
    ]
    kw_extra = {"interpret": True} if args.interpret else {}

    def timed(fn):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        return time.perf_counter() - t0

    for scheme in args.schemes.split(","):
        state, dt = scheme_state(scheme, args.ncols, np.float32, c)
        scan, kernel = scheme_fns(scheme)

        def run_scan():
            return scan(state, dt, c)

        def run_kernel(cfg=None):
            kw = dict(kw_extra)
            if cfg:
                kw.update(block_cols=cfg[0], num_warps=cfg[1])
            return kernel(state, dt, c, **kw)

        if args.check:
            t_scan = timed(run_scan)
            t_kern = timed(run_kernel)
            errs = field_errors(run_scan(), run_kernel())
            lowered = kernel.lower(state, dt, c, **kw_extra)
            mem = lowered.compile().memory_analysis()
            emit({
                "scheme": scheme, "ncols": args.ncols, "mode": "check",
                "first_call_s": {"scan": t_scan, "kernel": t_kern},
                "errors": {n: {"max_abs": a, "max_rel_to_field_max": r}
                           for n, (a, r) in errs.items()},
                "memory_analysis": str(mem),
                "peak_bytes_in_use": dev.memory_stats().get("peak_bytes_in_use")
                if dev.memory_stats() else None,
            })
            continue

        variants = [("scan", None)] + [("kernel", cfg) for cfg in (configs or [None])]
        for name, cfg in variants:  # warm-up: compile every variant first
            t = timed(run_scan if cfg is None and name == "scan" else lambda: run_kernel(cfg))
            emit({"scheme": scheme, "variant": name, "config": cfg, "compile_and_first_s": t})
        times = {}
        order = variants + variants[::-1]  # scan, kernels..., kernels..., scan
        for name, cfg in order:
            fn = run_scan if name == "scan" else (lambda cfg=cfg: run_kernel(cfg))
            samples = [timed(fn) for _ in range(args.reps)]
            times.setdefault(f"{name}{'' if cfg is None else cfg}", []).append(
                statistics.median(samples)
            )
        emit({
            "scheme": scheme, "ncols": args.ncols, "mode": "time",
            "median_s_per_turn": times,
            "cols_per_s": {k: args.ncols / statistics.median(v) for k, v in times.items()},
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())
