# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Headline benchmark: NL/TL/AD throughput (columns/sec) on one GPU.

Protocol follows the reference driver (``drivers/run_nonlinear.py:109-119``:
warm-up, then timed iterations).  The timed unit is a *chain* of physics
steps inside a single jitted ``lax.fori_loop`` (each step feeds an output
of EVERY kernel being timed back into the next step's state, so XLA can
neither collapse the chain nor dead-code-eliminate a kernel), and the
per-step time is the difference between a long and a short chain, each
timed on the host around ``jax.block_until_ready``: dispatch overhead
cancels.  Each scheme runs the implementation ``dispatch`` picks for
``impl="auto"`` (the GPU kernel where one was kept).

``vs_baseline`` is the fraction of the card's HBM speed of light for the
headline NL forward step: its minimum traffic per column over the card's
published bandwidth (:data:`PEAKS`).

Before timing, the chain implementations are certified against the
``lax.scan`` paths on the exact chain states (``certify``); a mismatch
emits the one JSON line with an ``error`` field instead of a number.

Prints exactly ONE JSON line, naming the platform, device kind and device
count.  Without a GPU it prints the line with an ``error`` and exits 1.
"""
from __future__ import annotations

import json
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cloudsc2_tpu import iox, make_constants
from cloudsc2_tpu.config import enable_compile_cache
from cloudsc2_tpu.dispatch import scheme_fn, use_kernel
from cloudsc2_tpu.parallel.step import forward_step
from cloudsc2_tpu.physics.diagnostics import eta_levels
from cloudsc2_tpu.physics.increment import state_increment
from cloudsc2_tpu.physics.saturation import saturation
from cloudsc2_tpu.validation.kernels import field_errors
from cloudsc2_tpu.validation.symmetry import DIAG_NAMES, TEND_NAMES

NCOLS = 1 << 16  # 65,536 columns
NLEV = 137
SYNTH_COLS = 4096  # host-side synthesis size; tiled to NCOLS on device
REPEATS = 5
DTYPE = jnp.float32
#: certification bound: largest field error over that field's largest
#: magnitude, kernel against scan (measured on the H100: 6.7e-5 at worst,
#: the AD's lu_i; see chip_smoke.KERNEL_TOL)
CERTIFY_TOL = 1e-3

#: published peaks by ``device_kind``: HBM bytes/s and non-tensor-core f32
#: FLOP/s (NVIDIA H100 and H200 data sheets, dense rates at the full power
#: limit).  A device that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
    "NVIDIA H100 PCIe": {"hbm_bytes_per_s": 2.0e12, "f32_flops_per_s": 51e12},
    "NVIDIA H100 NVL": {"hbm_bytes_per_s": 3.9e12, "f32_flops_per_s": 60e12},
    "NVIDIA H200": {"hbm_bytes_per_s": 4.8e12, "f32_flops_per_s": 67e12},
}


def device_peaks(kind: str) -> dict:
    """The :data:`PEAKS` entry of a device kind; raises for an unknown one."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; add it to bench.PEAKS")
    return PEAKS[kind]


def bytes_per_column(nlev: int, itemsize: int) -> int:
    """Minimum HBM traffic per column per NL step: 14 full-level inputs + 1
    interface input, 6 full-level + 4 interface outputs (qsat/eta fused)."""
    full_in, iface_in, full_out, iface_out = 14, 1, 6, 4
    return itemsize * (
        (full_in + full_out) * nlev + (iface_in + iface_out) * (nlev + 1)
    )


def note(msg: str) -> None:
    """Progress marker on stderr (stdout carries exactly one JSON line)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def chain_seconds(chain, state, dt, c, long_n, short_n) -> float:
    """Per-step seconds from the long/short chain difference, the median
    over :data:`REPEATS` pairs."""
    for n in (short_n, long_n):  # compile both lengths
        t0 = time.perf_counter()
        jax.block_until_ready(chain(state, n, dt, c))
        note(f"{chain.__name__} n={n} compile + first run {time.perf_counter() - t0:.1f}s")

    per = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(state, short_n, dt, c))
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(chain(state, long_n, dt, c))
        t_long = time.perf_counter() - t0
        per.append((t_long - t_short) / (long_n - short_n))
    return float(np.median(per))


def _eps(s):
    return jnp.asarray(1e-30, s["t"].dtype)


@partial(jax.jit, static_argnames=("n", "dt", "c"))
def chain_nl(state, n, dt, c):
    """n fused forward steps (saturation + NL), state fed back."""

    def body(_, s):
        tends, _diags = forward_step(s, dt, c)
        s = dict(s)
        # minimal data dependence between steps (physically negligible, but
        # prevents XLA from collapsing the chain); the timed unit stays the
        # reference's saturation + NL on an unchanged state
        s["t"] = s["t"] + _eps(s) * tends["t"]
        return s

    return jax.lax.fori_loop(0, n, body, dict(state))["t"]


@partial(jax.jit, static_argnames=("n", "dt", "c"))
def chain_tl(state, n, dt, c):
    """n tangent-linear steps; consumes forward AND tangent outputs."""
    tl = scheme_fn("tl", "auto", state["ap"].dtype, c)

    def body(_, s):
        tends, _diags = tl(s, dt, c)
        s = dict(s)
        s["t"] = s["t"] + _eps(s) * tends["t"]
        s["t_i"] = s["t_i"] + _eps(s) * tends["t_i"]
        return s

    s = jax.lax.fori_loop(0, n, body, dict(state))
    return s["t"] + s["t_i"]


@partial(jax.jit, static_argnames=("n", "dt", "c"))
def chain_ad(state, n, dt, c):
    """n adjoint steps (forward trajectory + reverse transpose); consumes a
    forward tendency AND a reverse-sweep cotangent so neither sweep can be
    dead-code-eliminated."""
    ad = scheme_fn("ad", "auto", state["ap"].dtype, c)

    def body(_, s):
        tends, diags = ad(s, dt, c)
        s = dict(s)
        s["t"] = s["t"] + _eps(s) * tends["t"] + _eps(s) * diags["t_i"]
        return s

    return jax.lax.fori_loop(0, n, body, dict(state))["t"]


def build_nl_state(ncols: int = NCOLS):
    """The NL chain's input state (tiled synthetic columns) and dt.

    ``eta`` is diagnosed here, once, exactly as the drivers do (EtaLevels
    runs before the timed loop): it is loop-invariant, and deriving it
    inside the timed step would time work the drivers do not repeat."""
    _, state_np, dt = iox.synthesize_input(
        ncols=min(SYNTH_COLS, ncols), nlev=NLEV, seed=0
    )
    reps = -(-ncols // SYNTH_COLS)
    state = {
        k: (
            jnp.tile(jnp.asarray(v, DTYPE), (1, reps))[:, :ncols]
            if v.ndim == 2
            else jnp.asarray(v, DTYPE)
        )
        for k, v in state_np.items()
    }
    state["eta"] = eta_levels(state["ap"], state["aph"])
    return state, dt


def build_tl_state(state, dt, c):
    """TL chain state: eta + qsat + increments, mirroring the symmetry-test
    pipeline (validation/symmetry.py)."""
    s = dict(state)
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    s.update(state_increment(s, 0.01, ignore_supsat=True))
    return s


def build_ad_state(s_tl, tends_tl, diags_tl):
    """AD chain state: the TL state plus cotangent seeds from one TL run."""
    s_ad = dict(s_tl)
    for name in TEND_NAMES:
        s_ad["tnd_" + name] = tends_tl[name]
        s_ad["tnd_" + name + "_i"] = tends_tl[name + "_i"]
    for name in DIAG_NAMES:
        s_ad[name + "_i"] = diags_tl[name + "_i"]
    return s_ad


def certify(states, dt, c) -> str | None:
    """Each scheme's ``auto`` implementation against its ``lax.scan`` path
    on the exact chain states — the bench cannot time a silently wrong
    kernel (reference ``--enable-validation`` default-on,
    ``run_nonlinear.py:139-147``).  Returns an error string or None."""
    for scheme, s in states.items():
        got = jax.block_until_ready(scheme_fn(scheme, "auto", s["ap"].dtype, c)(s, dt, c))
        ref = jax.block_until_ready(scheme_fn(scheme, "scan", s["ap"].dtype, c)(s, dt, c))
        errs = field_errors(ref, got)
        worst = max(errs, key=lambda n: errs[n][1])
        note(f"certify {scheme}: worst {worst} {errs[worst][1]:.3e}")
        if not errs[worst][1] <= CERTIFY_TOL:
            return f"certify {scheme}/{worst}: rel err {errs[worst][1]:.3e}"
    return None


def main() -> int:
    devices = jax.devices()
    dev = devices[0]
    head = {
        "metric": "nl_columns_per_sec",
        "unit": "columns/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(devices),
    }
    if dev.platform != "gpu":
        print(json.dumps({**head, "value": None, "vs_baseline": None,
                          "error": f"no GPU: JAX runs on {dev.platform!r}"}))
        return 1
    peaks = device_peaks(dev.device_kind)
    enable_compile_cache()
    c = make_constants(lphylin=True, ldrain1d=False)
    state, dt = build_nl_state()
    s_nl = dict(state)
    s_nl["qsat"] = saturation(s_nl["ap"], s_nl["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    s_tl = build_tl_state(state, dt, c)
    tends_tl, diags_tl = scheme_fn("tl", "auto", DTYPE, c)(s_tl, dt, c)
    s_ad = build_ad_state(s_tl, tends_tl, diags_tl)

    err = certify({"nl": s_nl, "tl": s_tl, "ad": s_ad}, dt, c)
    if err:
        print(json.dumps({**head, "value": None, "vs_baseline": None, "error": err}))
        return 1

    nl_cols = NCOLS / chain_seconds(chain_nl, state, dt, c, 64, 8)
    note(f"NL {nl_cols / 1e6:.2f}M cols/s")
    tl_cols = NCOLS / chain_seconds(chain_tl, s_tl, dt, c, 32, 4)
    note(f"TL {tl_cols / 1e6:.2f}M cols/s")
    ad_cols = NCOLS / chain_seconds(chain_ad, s_ad, dt, c, 32, 4)
    note(f"AD {ad_cols / 1e6:.2f}M cols/s")

    sol = peaks["hbm_bytes_per_s"] / bytes_per_column(NLEV, np.dtype(np.float32).itemsize)
    print(json.dumps({
        **head,
        "value": nl_cols,
        "vs_baseline": nl_cols / sol,
        "tl_columns_per_sec": tl_cols,
        "ad_columns_per_sec": ad_cols,
        "impl": {
            s: "kernel" if use_kernel("auto", s, DTYPE, c) else "scan"
            for s in ("nl", "tl", "ad")
        },
        "hbm_bytes_per_s": peaks["hbm_bytes_per_s"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
