
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLI driver: symmetry test for the adjoint scheme.

Rebuild of the reference ``drivers/run_symmetry_test.py:41-198``: assemble
the state, run the symmetry protocol (``<Mx,Mx> == <x, M*(Mx)>`` per
column), print the verdict, re-run ``--num-runs`` times for timing.
Exit code 0 iff the maximum error < 1e4 machine epsilons.
"""
from __future__ import annotations

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from drivers.config import DEFAULT_CONFIG, DEFAULT_IO_CONFIG
from drivers.run_nonlinear import _flag_pair


def core(config, io_config, factor, config_impl="scan"):
    import jax.numpy as jnp

    from cloudsc2_tpu import iox, make_constants
    from cloudsc2_tpu.components import EtaLevels
    from cloudsc2_tpu.utils.output import (
        print_performance,
        write_performance_to_csv,
        write_stencils_performance_to_csv,
    )
    from cloudsc2_tpu.utils.timing import Timer, timing
    from cloudsc2_tpu.validation.symmetry import SymmetryTest

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

    state = {k: jnp.asarray(v, dtype=dtype) for k, v in state_np.items()}
    state.update(EtaLevels(grid, c)(state))

    mesh = None
    if config.sharded:
        # mirror run_nonlinear.py --sharded: eta first (global column 0),
        # pad to the mesh multiple (replicating column 0 — valid physics;
        # the symmetry norms stay exact per column), then shard
        from cloudsc2_tpu.parallel.mesh import column_mesh, pad_columns, shard_state

        mesh = column_mesh()
        state, _ = pad_columns(state, mesh.devices.size)
        state = shard_state(state, mesh)

    st = SymmetryTest(constants=c, factor=factor, impl=config_impl, mesh=mesh)
    Timer.reset()
    err = float("inf")
    runtimes = []
    for _ in range(config.num_runs):
        with timing("run"):
            err = st(state, dt, verbose=True)
        runtimes.append(Timer.get_time("run", "ms") - sum(runtimes))
    stats = print_performance(grid.ncols, runtimes, nlev=grid.nlev)
    if io_config.output_csv_file:
        import jax

        write_performance_to_csv(
            io_config.output_csv_file,
            host_name=io_config.host_name,
            precision=config.precision,
            variant="ad-jax:" + jax.devices()[0].platform,
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
            key_patterns=("cloudsc", "saturation", "increment"),
        )
    return 0 if err < 1e4 else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default=None, help="JAX platform: gpu | cpu (default: env)")
    ap.add_argument("--num-cols", type=int, default=100)
    ap.add_argument("--num-runs", type=int, default=1)
    ap.add_argument("--precision", choices=["double", "single"], default="double")
    ap.add_argument("--factor", type=float, default=0.01)
    ap.add_argument("--input-file", default=None)
    ap.add_argument("--output-csv-file", default=None)
    ap.add_argument("--output-csv-file-stencils", default=None)
    ap.add_argument("--impl", choices=["auto", "scan", "pallas", "pallas-interpret"],
                    default="scan", help="implementation (pallas: the f32 GPU kernels)")
    _flag_pair(ap, "sharded", False,
               "column-shard the TL/AD schemes over all devices (shard_map)")
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
    return core(config, io_config, a.factor, a.impl)


if __name__ == "__main__":
    sys.exit(main())
