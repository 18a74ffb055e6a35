
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Worker process for the multi-host distribution test.

Each worker is one "host" of a two-process JAX cluster (4 virtual CPU
devices per process — the CPU stand-in for one host of several GPUs,
SURVEY.md §2.3): it initializes ``jax.distributed`` against a local
coordinator, builds the 2-D ``('node', 'device')`` mesh spanning both
processes, assembles a globally column-sharded state from process-local
shards, runs the forward step, and checks its local output shards against a
single-process computation of the same global state.

Invoked by ``tests/test_distributed.py`` as:
    python distributed_worker.py <coordinator_port> <process_id> <num_processes>
"""
import os
import sys

# per-worker platform setup must precede any jax import side effects
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (
    " ".join(f for f in flags.split() if "host_platform_device_count" not in f)
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def main() -> None:
    port, pid, nproc = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

    from cloudsc2_tpu.parallel.mesh import initialize_distributed

    # the multi-host entry point (no-op on single process); here: explicit
    # local coordinator
    initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid, jax.process_index()
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == nproc * n_local, (n_global, n_local)

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cloudsc2_tpu import iox, make_constants
    from cloudsc2_tpu.parallel.mesh import MESH_AXES, column_mesh, column_sharding
    from cloudsc2_tpu.parallel.step import forward_step

    # the ('node', 'device') mesh must factor over host boundaries
    mesh = column_mesh()
    assert dict(mesh.shape) == {"node": nproc, "device": n_local}, mesh.shape
    # outer (node) axis rows must be process-aligned so its collectives
    # would ride DCN, inner-axis ones ICI (SURVEY.md §2.3)
    for row, devs in enumerate(mesh.devices):
        assert {d.process_index for d in devs} == {row}, mesh.devices

    ncols = 4 * n_global  # 4 columns per device
    dtype = np.float32
    _, state_np, dt = iox.synthesize_input(ncols=ncols, nlev=137, seed=0, dtype=dtype)
    c = make_constants(lphylin=True, ldrain1d=False)

    # assemble global arrays from process-local column blocks
    col = column_sharding(mesh)
    rep = NamedSharding(mesh, P())

    def make_global(v):
        if v.ndim != 2:
            return jax.make_array_from_callback(v.shape, rep, lambda idx: v[idx])
        return jax.make_array_from_callback(
            v.shape, col, lambda idx, v=v: v[idx]
        )

    state = {k: make_global(v) for k, v in state_np.items()}
    assert state["ap"].sharding.is_fully_addressable is False  # truly multi-host

    step = jax.jit(lambda s: forward_step(s, dt, c, impl="scan"))
    tends, diags = step(state)
    jax.block_until_ready(tends)

    # single-process oracle on the full (replicated, host-local) input
    with jax.default_device(jax.local_devices()[0]):
        state_local = {k: jnp.asarray(v) for k, v in state_np.items()}
        tends_ref, diags_ref = jax.jit(
            lambda s: forward_step(s, dt, c, impl="scan")
        )(state_local)
        tends_ref = {k: np.asarray(v) for k, v in tends_ref.items()}
        diags_ref = {k: np.asarray(v) for k, v in diags_ref.items()}

    checked = 0
    for name, out in list(tends.items()) + [("clc", diags["clc"])]:
        ref = tends_ref.get(name, diags_ref.get(name))
        for shard in out.addressable_shards:
            want = ref[shard.index]
            got = np.asarray(shard.data)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=name)
            assert np.isfinite(got).all(), name
            checked += 1
    assert checked == 5 * n_local, checked
    assert np.abs(tends_ref["t"]).max() > 0  # non-vacuous
    print(f"DISTRIBUTED-OK pid={pid} devices={n_global} checked={checked}", flush=True)


if __name__ == "__main__":
    main()
