# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The GPU level-scan kernels on the CPU: the harness on a toy recurrence,
each scheme's kernel in interpret mode against its ``lax.scan`` path, the
kernels' lowering for CUDA, and the implementation dispatch.

The kernels share their per-level physics with the scan paths, so the
comparisons here check the kernel's orchestration: the level loop in both
directions, the carry, masked ragged column blocks, the trajectory and
seed streams.  Compiled-kernel checks run on the card through
``chip_smoke.py`` (the ``gpu`` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudsc2_tpu import make_constants
from cloudsc2_tpu.dispatch import scheme_fns
from cloudsc2_tpu.pallas.levelscan import level_scan_pallas
from cloudsc2_tpu.validation.kernels import field_errors, scheme_state

# --- the harness on a toy recurrence ---------------------------------------

TOY_NLEV = 7


def _toy_problem(ncols):
    rng = np.random.default_rng(ncols)
    a = rng.random((TOY_NLEV, ncols)).astype(np.float32)
    w = rng.random(ncols).astype(np.float32)
    s = np.arange(TOY_NLEV, dtype=np.float32) * 0.25
    return a, w, s


def _toy_body(carry, x, col, _k):
    (c,) = carry
    c_new = 0.5 * c + x["a"] * col["w"] + x["s"]
    return (c_new,), {"y": jnp.exp(-c_new) + jnp.where(c_new > 1.0, c_new, 0.0),
                      "c_in": c}


def _toy_reference(a, w, s, reverse):
    c = np.zeros(a.shape[1], np.float64)
    y, c_in = np.zeros(a.shape), np.zeros(a.shape)
    for k in (range(TOY_NLEV - 1, -1, -1) if reverse else range(TOY_NLEV)):
        c_in[k] = c
        c = 0.5 * c + a[k].astype(np.float64) * w + s[k]
        y[k] = np.exp(-c) + np.where(c > 1.0, c, 0.0)
    return y, c_in


@pytest.mark.parametrize("block_cols", [32, 128, 256])
@pytest.mark.parametrize("ncols", [100, 300])
@pytest.mark.parametrize("reverse", [False, True])
def test_level_scan_toy_recurrence(reverse, ncols, block_cols):
    """Forward and reverse sweeps, with the carry entering each level as a
    trajectory output, over ragged column counts (the last block masked)
    and several block widths."""
    a, w, s = _toy_problem(ncols)
    out = level_scan_pallas(
        _toy_body,
        level_inputs={"a": jnp.asarray(a)},
        col_inputs={"w": jnp.asarray(w)},
        scalar_inputs={"s": jnp.asarray(s)},
        out_names=("y", "c_in"),
        ncarry=1,
        block_cols=block_cols,
        num_warps=4,
        reverse=reverse,
        interpret=True,
    )
    y, c_in = _toy_reference(a, w, s, reverse)
    assert out["y"].shape == (TOY_NLEV, ncols) and out["y"].dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out["y"]), y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out["c_in"]), c_in, rtol=1e-5, atol=1e-6)


def test_level_scan_rejects_bad_inputs():
    a, w, s = _toy_problem(100)
    kw = dict(
        col_inputs={"w": jnp.asarray(w)}, scalar_inputs={"s": jnp.asarray(s)},
        out_names=("y",), ncarry=1, num_warps=4, interpret=True,
    )
    with pytest.raises(ValueError, match="power of two"):
        level_scan_pallas(_toy_body, level_inputs={"a": jnp.asarray(a)}, block_cols=96, **kw)
    with pytest.raises(ValueError, match="level input"):
        level_scan_pallas(
            _toy_body,
            level_inputs={"a": jnp.asarray(a), "b": jnp.asarray(a[:-1])},
            block_cols=64, **kw,
        )


# --- each scheme's kernel against its scan path ----------------------------


def _constants(cfg):
    c = make_constants(lphylin=cfg != "no_lphylin", ldrain1d=cfg == "ldrain1d")
    return c.replace(LEVAPLS2=True) if cfg == "levapls2" else c


#: largest field error over that field's largest magnitude.  Same level
#: bodies, f32 on both sides; what differs is XLA's fusion of the scan loop
#: against the kernel's, a few ulps per level (measured below 1e-6 here).
KERNEL_TOL = 1e-5

CASES = [
    (scheme, cfg)
    for scheme in ("nl", "tl", "ad")
    for cfg in ("default", "levapls2", "ldrain1d", "no_lphylin")
    # the adjoint kernel needs LPHYLIN=True (its forward sweep is the NL)
    if not (scheme == "ad" and cfg == "no_lphylin")
]


@pytest.mark.parametrize("ncols", [100, 256])
@pytest.mark.parametrize("scheme,cfg", CASES)
def test_kernel_matches_scan(scheme, cfg, ncols):
    c = _constants(cfg)
    state, dt = scheme_state(scheme, ncols, np.float32, c)
    scan, kernel = scheme_fns(scheme)
    errs = field_errors(scan(state, dt, c), kernel(state, dt, c, interpret=True))
    worst = max(errs, key=lambda n: errs[n][1])
    assert errs[worst][1] <= KERNEL_TOL, (worst, errs[worst])
    if scheme == "ad" and cfg != "default":
        # the evaporation branch's surface-pressure cotangent path fires
        _, diags = kernel(state, dt, c, interpret=True)
        assert np.abs(np.asarray(diags["aph_i"][-1])).max() > 0.0


def test_kernel_symmetry():
    """The TL and AD kernels together satisfy <Mx,Mx> = <x,M*(Mx)> — the
    reference's AD acceptance gate (adjoint/validation.py:155-165)."""
    from cloudsc2_tpu.validation.symmetry import SymmetryTest

    c = _constants("default")
    state, dt = scheme_state("nl", 256, np.float32, c)
    state = {k: v for k, v in state.items() if k != "qsat"}
    err = SymmetryTest(constants=c, impl="pallas-interpret")(state, dt, verbose=False)
    assert err < 1e4, err


# --- the kernels' lowering for the GPU, on the CPU -------------------------


@pytest.mark.parametrize("scheme,cfg", [
    ("nl", "default"), ("nl", "levapls2"), ("tl", "default"), ("tl", "ldrain1d"),
    ("ad", "default"), ("ad", "levapls2"),
])
def test_kernel_lowers_for_cuda(scheme, cfg):
    """Every primitive of the level bodies (and of the vjp the adjoint's
    reverse body takes) lowers through Pallas's Triton route; the GPU's own
    compiler runs on the card (chip_smoke.py)."""
    c = _constants(cfg)
    state, dt = scheme_state(scheme, 64, np.float32, c)
    _, kernel = scheme_fns(scheme)
    lowered = jax.jit(lambda s: kernel(s, dt, c)).trace(state).lower(
        lowering_platforms=("cuda",)
    )
    assert "triton" in lowered.as_text()


# --- implementation dispatch -----------------------------------------------


@pytest.mark.parametrize("backend,dtype,scheme,lphylin,expected", [
    ("gpu", np.float32, "nl", True, True),
    ("gpu", np.float32, "ad", True, True),
    ("gpu", np.float32, "ad", False, False),
    ("gpu", np.float64, "tl", True, False),
    ("cpu", np.float32, "nl", True, False),
])
def test_auto_dispatch(monkeypatch, backend, dtype, scheme, lphylin, expected):
    from cloudsc2_tpu.dispatch import scheme_fn, use_kernel

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    c = make_constants(lphylin=lphylin, ldrain1d=False)
    assert use_kernel("auto", scheme, dtype, c) is expected
    scan, kernel = scheme_fns(scheme)
    assert scheme_fn(scheme, "auto", dtype, c) is (kernel if expected else scan)


@pytest.mark.parametrize("impl,dtype,scheme,lphylin", [
    ("pallas", np.float64, "nl", True),
    ("pallas-interpret", np.float64, "tl", True),
    ("pallas", np.float32, "ad", False),
    ("tiled", np.float32, "nl", True),
])
def test_explicit_kernel_never_falls_back(impl, dtype, scheme, lphylin):
    from cloudsc2_tpu.dispatch import scheme_fn

    c = make_constants(lphylin=lphylin, ldrain1d=False)
    with pytest.raises(ValueError, match="impl="):
        scheme_fn(scheme, impl, dtype, c)


def test_component_explicit_kernel_raises(state_with_qsat, constants):
    """The components route through the same dispatch: an explicit kernel
    impl on a state the kernel cannot take raises instead of running scan."""
    from cloudsc2_tpu.components import Cloudsc2NL

    grid, state, dt = state_with_qsat
    with pytest.raises(ValueError, match="no NL kernel for float64"):
        Cloudsc2NL(grid, constants, impl="pallas")(state, dt)


@pytest.mark.gpu
def test_kernels_compiled_on_gpu():
    """The compiled kernels against scan at the benchmark width; runs on
    the card only (``python chip_smoke.py`` runs the same comparison)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled kernels have no CPU lowering")
    c = _constants("default")
    for scheme in ("nl", "tl", "ad"):
        state, dt = scheme_state(scheme, 65536, np.float32, c)
        scan, kernel = scheme_fns(scheme)
        errs = field_errors(scan(state, dt, c), kernel(state, dt, c))
        assert max(e[1] for e in errs.values()) <= 1e-3, errs
