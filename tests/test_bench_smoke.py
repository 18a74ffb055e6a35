# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Structural smoke tests for the headline benchmark (bench.py) and the
card's smoke test (chip_smoke.py).

bench.py runs on the GPU and json-parses into one output line; a structural
regression there (a chain whose fori_loop carry changes pytree structure, a
renamed state key) would silently cost the benchmark artifact.
``jax.eval_shape`` traces the full chains without a GPU, so these tests
catch that class of bug on the CPU in seconds.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import bench
from cloudsc2_tpu import make_constants

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def states():
    c = make_constants(lphylin=True, ldrain1d=False)
    state, dt = bench.build_nl_state(ncols=256)
    s_tl = bench.build_tl_state(state, dt, c)
    return state, s_tl, dt, c


def test_chain_nl_traces(states):
    state, _, dt, c = states
    out = jax.eval_shape(lambda s: bench.chain_nl(s, 8, dt, c), state)
    assert out.shape == state["t"].shape and out.dtype == state["t"].dtype


def test_chain_tl_traces(states):
    _, s_tl, dt, c = states
    out = jax.eval_shape(lambda s: bench.chain_tl(s, 4, dt, c), s_tl)
    assert out.shape == s_tl["t"].shape


def test_chain_ad_traces(states):
    _, s_tl, dt, c = states
    from cloudsc2_tpu.physics.tangent_linear import cloudsc2_tl

    tends_tl, diags_tl = jax.eval_shape(lambda s: cloudsc2_tl(s, dt, c), s_tl)
    s_ad_abs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in s_tl.items()}
    s_ad_abs = bench.build_ad_state(s_ad_abs, tends_tl, diags_tl)
    out = jax.eval_shape(lambda s: bench.chain_ad(s, 4, dt, c), s_ad_abs)
    assert out.shape == s_tl["t"].shape


def test_roofline_denominator():
    # 14 full + 1 interface inputs, 6 full + 4 interface outputs, f32
    bpc = bench.bytes_per_column(137, 4)
    assert bpc == 4 * ((14 + 6) * 137 + (1 + 4) * 138)


@pytest.mark.parametrize("kind,hbm", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
])
def test_peak_table_h100(kind, hbm):
    peaks = bench.device_peaks(kind)
    assert peaks["hbm_bytes_per_s"] == hbm and peaks["f32_flops_per_s"] > 0


@pytest.mark.parametrize("kind", ["AMD Instinct MI300X", "cpu", "NVIDIA H100"])
def test_peak_table_unknown_kind_raises(kind):
    """An unlisted device is an error, never a silent default."""
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks(kind)


def test_bench_without_gpu_prints_one_error_line(capsys):
    """No GPU: one JSON line with an error naming the platform, exit 1."""
    assert bench.main() == 1
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["platform"] == "cpu" and "no GPU" in rec["error"]
    assert rec["device_count"] >= 1 and rec["value"] is None


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no GPU" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Copied out of the repository, the script cannot run the system."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
