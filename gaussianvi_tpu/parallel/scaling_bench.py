"""Factor-parallel scaling-efficiency harness.

North-star target (BASELINE.json): >= 0.8 scaling efficiency on
factor-parallel throughput at N >= 2 hosts.  This harness measures sharded
NGD-step throughput across mesh shapes on whatever devices exist (several
GPUs, or the virtual CPU mesh for plumbing validation — virtual devices
share host cores, so efficiency numbers are only meaningful on hardware).

Usage:
    python -m gaussianvi_tpu.parallel.scaling_bench [max_devices]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp


def measure_mesh(dp, fp, num_states=64, dim_x=2, niters=5, repeats=3):
    from gaussianvi_tpu.examples.chain_estimation import build_chain_estimation
    from gaussianvi_tpu.inference import GVIConfig
    from gaussianvi_tpu.parallel import (
        make_mesh,
        optimize_sharded,
        stack_problems,
    )

    mesh = make_mesh(dp=dp, fp=fp)
    graphs, states = [], []
    for seed in range(dp):
        graph, init, _ = build_chain_estimation(
            num_states=num_states, dim_x=dim_x, gh_degree=4, seed=seed
        )
        graphs.append(graph)
        states.append(init)
    graph_b, state_b = stack_problems(graphs, states)
    config = GVIConfig(niters=niters, step_size_base=0.9)

    def run():
        out, _ = optimize_sharded(graph_b, state_b, config, mesh)
        return float(jnp.sum(out.mu))  # host sync

    run()  # compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return dp * niters / best  # problem-iterations per second


def mesh_shapes(n):
    """All power-of-2 (dp, fp) splits of up to n devices."""
    shapes = [(1, 1)]
    d = 2
    while d <= n:
        shapes.extend(
            (dp, d // dp)
            for dp in (2 ** k for k in range(d.bit_length()))
            if dp <= d and d % dp == 0
        )
        d *= 2
    return sorted(set(shapes))


def main(max_devices=None):
    n = len(jax.devices())
    if max_devices:
        n = min(n, int(max_devices))
    results = {}
    for dp, fp in mesh_shapes(n):
        rate = measure_mesh(dp, fp)
        results[(dp, fp)] = rate
        base = results[(1, 1)]
        eff = rate / (base * dp * fp)
        print(
            f"mesh dp={dp} fp={fp}: {rate:.2f} prob-iters/s, "
            f"scaling efficiency {eff:.2f}",
            flush=True,
        )
    return results


if __name__ == "__main__":
    main(*sys.argv[1:2])
