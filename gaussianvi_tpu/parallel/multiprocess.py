"""Multi-process execution: the dp axis across processes.

The reference is strictly single-process — its parallelism is OpenMP
threads and one CUDA device (SURVEY.md section 5.8).  Here the
data-parallel problem axis spans PROCESSES: ``jax.distributed``
initialization, one global (dp, fp) mesh over every process's devices,
global arrays built from identically-constructed host data, and the same
:func:`.sharding.optimize_sharded` loop — the all-reduce-free problem axis
spans processes while fp's psum stays within each process's devices.

Launch (one process each):

    python -m gaussianvi_tpu.parallel.multiprocess \
        --coordinator HOST:PORT --num-processes P --process-id I \
        [--local-device-ids 0,1]

A JAX process reserves most of each card's memory when it first uses
it, so several processes on ONE GPU host must each open only their own
cards: pass ``--local-device-ids`` (``jax.distributed.initialize``'s
``local_device_ids``), e.g. process I of four on a four-card host gets
``--local-device-ids I``.  Nothing tells JAX of a cluster: the
coordinator address, process count and id are always explicit.  For
plumbing tests without hardware, ``--cpu-devices K`` gives each process K
virtual CPU devices (this is what tests/test_multiprocess.py does with 2
processes x 4 devices).
"""

from __future__ import annotations

import argparse
import os
import sys


def initialize_multiprocess(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    cpu_devices: int | None = None,
    local_device_ids: list[int] | None = None,
) -> None:
    """Initialize jax.distributed.  Call before any other JAX use.

    ``cpu_devices``: force the CPU backend with that many virtual devices
    per process (testing without hardware).  ``local_device_ids``: the
    cards this process opens (several processes on one GPU host).
    """
    if cpu_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={cpu_devices}"
            ).strip()
    import jax

    if cpu_devices is not None:
        jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def put_global(tree, mesh, spec_tree):
    """Commit identically-replicated host data to a global (multi-process)
    sharding: every process passes the SAME host values; each transfers
    only its addressable shards."""
    import jax
    from jax.sharding import NamedSharding

    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        tree,
        spec_tree,
        is_leaf=lambda x: x is None,
    )


def _demo_main(argv=None) -> int:
    """2-process plumbing demo/test body: distributed optimize_sharded over
    a global (dp=num_processes, fp=local_devices) mesh, verified per
    process against the single-device ``optimize`` trajectories."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--cpu-devices", type=int, default=None)
    ap.add_argument("--local-device-ids", default=None,
                    help="comma-separated cards this process opens")
    args = ap.parse_args(argv)

    initialize_multiprocess(
        args.coordinator, args.num_processes, args.process_id,
        cpu_devices=args.cpu_devices,
        local_device_ids=(
            [int(i) for i in args.local_device_ids.split(",")]
            if args.local_device_ids else None
        ),
    )
    import jax

    if args.cpu_devices is not None:
        jax.config.update("jax_enable_x64", True)
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh

    from ..examples.chain_estimation import build_chain_estimation
    from ..inference import GVIConfig, optimize
    from .sharding import (
        _graph_specs,
        _state_spec,
        optimize_sharded,
        stack_problems,
    )

    n_proc = args.num_processes
    n_local = len(jax.local_devices())
    assert len(jax.devices()) == n_proc * n_local, (
        len(jax.devices()), n_proc, n_local,
    )

    # dp rows = processes, fp columns = each process's devices
    mesh = Mesh(
        np.asarray(jax.devices()).reshape(n_proc, n_local), ("dp", "fp")
    )

    # every process constructs the SAME global problem batch
    n_problems = n_proc
    graphs, states = [], []
    for seed in range(n_problems):
        g, s0, _ = build_chain_estimation(
            num_states=8, dim_x=1, gh_degree=4, seed=seed
        )
        graphs.append(g)
        states.append(s0)
    graph_b, state_b = stack_problems(graphs, states)
    graph_b = put_global(graph_b, mesh, _graph_specs(graph_b, batched=True))
    state_b = put_global(state_b, mesh, _state_spec(batched=True))

    config = GVIConfig(niters=3, step_size_base=0.9)
    state_g, hist_g = optimize_sharded(graph_b, state_b, config, mesh)

    # gather the distributed results to every host and compare with the
    # single-device loop run locally on the same problems
    costs = multihost_utils.process_allgather(hist_g.cost, tiled=True)
    mu = multihost_utils.process_allgather(state_g.mu, tiled=True)
    for i, (g, s0) in enumerate(zip(graphs, states)):
        final, hist = optimize(g, s0, config, method="ngd")
        np.testing.assert_allclose(costs[i], hist.cost, rtol=1e-9)
        np.testing.assert_allclose(mu[i], final.mu, rtol=1e-7, atol=1e-10)

    print(
        f"MULTIPROC OK pid={args.process_id} devices={len(jax.devices())} "
        f"costs0={costs[0].tolist()}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(_demo_main())
