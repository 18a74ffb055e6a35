
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLI driver: Taylor (V-shape) test for the tangent-linear scheme.

Rebuild of the reference ``drivers/run_taylor_test.py:41-200``: assemble the
state, run the Taylor protocol (perturb by ``factor1``, sweep ``factor2``
over 1e-1..1e-10), print the norm table and verdict, re-run ``--num-runs``
times for timing.  Exit code 0 iff penalty <= 5.
"""
from __future__ import annotations

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from drivers.config import DEFAULT_CONFIG, DEFAULT_IO_CONFIG
from drivers.run_nonlinear import _flag_pair


def core(config, io_config, factor1, factor2s, config_impl="scan", floors="f64",
         tile_column=False, per_column=False):
    import jax.numpy as jnp

    from cloudsc2_tpu import iox, make_constants
    from cloudsc2_tpu.components import EtaLevels
    from cloudsc2_tpu.utils.output import (
        print_performance,
        write_performance_to_csv,
        write_stencils_performance_to_csv,
    )
    from cloudsc2_tpu.utils.timing import Timer, timing
    from cloudsc2_tpu.validation.taylor import TaylorTest

    config.jax_config.apply()
    dtype = config.dtype

    from drivers.config import default_input_file

    input_file = config.input_file or default_input_file()
    if input_file:
        grid, state_np, dt, params = iox.load_input(
            input_file, ncols=config.num_cols, dtype=dtype
        )
        c = make_constants(lphylin=True, ldrain1d=False, **params)
    else:
        grid, state_np, dt = iox.synthesize_input(
            ncols=config.num_cols, nlev=137, seed=0, dtype=dtype
        )
        c = make_constants(lphylin=True, ldrain1d=False)

    if tile_column:
        # the reference driver's default is a SINGLE column
        # (run_taylor_test.py: --num-cols 1); replicating column 0 across
        # num_cols runs that protocol on a batch that fills the device —
        # the column-summed norms then equal the single-column norms.
        # Distinct columns stay the default: their summed norms are the
        # batched protocol, but a single column crossing a physics branch
        # between two lambdas can legitimately break V-monotonicity.
        import numpy as np

        state_np = {
            k: (np.repeat(v[:, :1], v.shape[1], axis=1) if np.ndim(v) == 2 else v)
            for k, v in state_np.items()
        }

    state = {k: jnp.asarray(v, dtype=dtype) for k, v in state_np.items()}
    state.update(EtaLevels(grid, c)(state))

    mesh = None
    if config.sharded:
        # mirror run_nonlinear.py --sharded: eta first (global column 0),
        # pad to the mesh multiple (replicating column 0 — valid physics;
        # the protocol leaves the padding out of its norms), then shard;
        # the schemes run under shard_map
        from cloudsc2_tpu.parallel.mesh import column_mesh, pad_columns, shard_state

        mesh = column_mesh()
        state, _ = pad_columns(state, mesh.devices.size)
        state = shard_state(state, mesh)

    tt = TaylorTest(
        constants=c, factor1=factor1, factor2s=factor2s, impl=config_impl,
        floors=floors, mesh=mesh, per_column=per_column, ncols=grid.ncols,
    )
    Timer.reset()
    test = 13
    runtimes = []
    for _ in range(config.num_runs):
        with timing("run"):
            test = tt(state, dt, verbose=True)
        runtimes.append(Timer.get_time("run", "ms") - sum(runtimes))
    stats = print_performance(grid.ncols, runtimes, nlev=grid.nlev)
    if io_config.output_csv_file:
        import jax

        write_performance_to_csv(
            io_config.output_csv_file,
            host_name=io_config.host_name,
            precision=config.precision,
            variant="tl-jax:" + jax.devices()[0].platform,
            num_cols=grid.ncols,
            num_threads=config.num_threads,
            num_runs=config.num_runs,
            runtime_mean=stats[0],
            runtime_stddev=stats[1],
            mflops_mean=stats[2],
            mflops_stddev=stats[3],
        )
    if io_config.output_csv_file_stencils:
        import jax

        write_stencils_performance_to_csv(
            io_config.output_csv_file_stencils,
            host_name=io_config.host_name,
            precision=config.precision,
            backend="jax:" + jax.devices()[0].platform,
            num_cols=grid.ncols,
            num_threads=config.num_threads,
            num_runs=config.num_runs,
            exec_info={k: Timer.get_time(k, "ms") for k in Timer.labels()},
            key_patterns=("cloudsc", "saturation", "increment", "perturbed"),
        )
    return 0 if test <= 5 else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default=None, help="JAX platform: gpu | cpu (default: env)")
    ap.add_argument("--num-cols", type=int, default=1)
    ap.add_argument("--num-runs", type=int, default=1)
    ap.add_argument("--precision", choices=["double", "single"], default="double")
    ap.add_argument("--factor1", type=float, default=0.01)
    ap.add_argument("--input-file", default=None)
    ap.add_argument("--output-csv-file", default=None)
    ap.add_argument("--output-csv-file-stencils", default=None)
    ap.add_argument("--impl", choices=["auto", "scan", "pallas", "pallas-interpret"],
                    default="scan",
                    help="implementation (pallas: the f32 GPU kernels; pair with "
                    "--floors auto/f32 — the reference's f64 verdict floors are below "
                    "single-precision resolution)")
    ap.add_argument("--floors", choices=["auto", "f64", "f32"], default="f64",
                    help="verdict floor calibration: f64 = the reference constants "
                    "(tangent_linear/validation.py:203-211); f32 = the measured "
                    "single-precision V-floor; auto picks by the state dtype")
    _flag_pair(ap, "sharded", False,
               "column-shard the NL/TL schemes over all devices (shard_map)")
    _flag_pair(ap, "tile-column", False,
               "replicate input column 0 across --num-cols: the reference's "
               "single-column protocol on a batch (distinct columns can "
               "legitimately break V-monotonicity when one crosses a physics "
               "branch between two lambdas)")
    _flag_pair(ap, "per-column", False,
               "run the V-shape verdict on every column's own norm sequence and "
               "pass iff >= 98%% of columns pass individually — the legitimate "
               "heterogeneous-batch verdict (the summed-norm V can be broken by a "
               "single branch-crossing column; a wrong TL fails essentially every "
               "column)")
    ap.add_argument("--host-alias", default="localhost")
    a = ap.parse_args(argv)
    config = (
        DEFAULT_CONFIG.with_precision(a.precision)
        .with_backend(a.backend)
        .with_num_cols(a.num_cols)
        .with_num_runs(a.num_runs)
        .with_input_file(a.input_file)
        .with_sharded(a.sharded)
    )
    io_config = (
        DEFAULT_IO_CONFIG.with_output_csv_file(a.output_csv_file)
        .with_output_csv_file_stencils(a.output_csv_file_stencils)
        .with_host_name(a.host_alias)
    )
    factor2s = tuple(float(10.0 ** -(i + 1)) for i in range(10))
    return core(config, io_config, a.factor1, factor2s, a.impl, a.floors,
                a.tile_column, a.per_column)


if __name__ == "__main__":
    sys.exit(main())
