"""GPU benchmark of the planning workloads.

The reference's timing harness times the planning configuration
(gvibase/GVI-GH-Cuda-impl.h:289-460 `factor_cost_vector_cuda_time`,
:463-527 `time_test`).  This script measures, on the GPU:

* planar point-robot planning (CudaOperation_PlanarPR analog) — NGD + prox
* 3-D point-robot planning (CudaOperation_3dpR analog) — NGD + prox

each as a B-restart batch (parallel perturbed restarts of one planning
problem, `parallel/restarts.py`), with the SDF lookup by gathers and by
one-hot hat contractions (``interp``), interleaved in one process.  Rates
are restarts x iterations over the median of timed runs (float32 data).

    python scripts/planning_bench.py [--restarts B] [--niters I]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp


def bench_case(name, build_fn, restarts, niters, methods, rounds=5):
    from gaussianvi_tpu.inference.optimize import optimize
    from gaussianvi_tpu.parallel.restarts import perturb_inits

    variants = {}
    for interp in ("gather", "matmul"):
        graph, init, config, _ = build_fn(
            gh_degree=3, interp=interp, dtype=jnp.float32
        )
        config = replace(config, niters=niters, niters_lowtemp=niters)
        init_b = perturb_inits(
            init, jax.random.key(0), restarts, mean_scale=0.3
        )
        variants[interp] = (graph, init_b, config)

    for method in methods:
        runs = {}
        for label, (graph, init_b, config) in variants.items():
            run = jax.jit(jax.vmap(
                lambda s0, g=graph, c=config, m=method:
                    optimize(g, s0, c, method=m)[1].cost[-1]
            ))
            t0 = time.perf_counter()
            final_costs = jax.block_until_ready(run(init_b))
            print(f"  {name}/{method}/{label}: compile+first "
                  f"{time.perf_counter() - t0:.0f}s, median final cost "
                  f"{float(jnp.median(final_costs)):.4f}", flush=True)
            runs[label] = run
        times = {k: [] for k in runs}
        for _ in range(rounds):
            for label, run in runs.items():
                t0 = time.perf_counter()
                jax.block_until_ready(run(variants[label][1]))
                times[label].append(time.perf_counter() - t0)
        for label, ts in times.items():
            dt = statistics.median(ts)
            print(f"  {name}/{method}/{label}: "
                  f"{restarts * niters / dt:10.1f} prob-iters/s "
                  f"({dt * 1e3:.2f} ms/call)", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=512)
    ap.add_argument("--niters", type=int, default=10)
    ap.add_argument("--cases", default="planar,point3d")
    ap.add_argument("--methods", default="ngd,prox")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit("planning_bench measures the GPU; JAX found none")
    jax.config.update("jax_enable_x64", True)

    from gaussianvi_tpu.examples.planar_planning import build_planar_planning
    from gaussianvi_tpu.examples.point3d_planning import build_point3d_planning

    print("device:", jax.devices()[0].device_kind, flush=True)
    methods = args.methods.split(",")
    if "planar" in args.cases:
        print(f"planar planning (N=20, s=4, B={args.restarts}):", flush=True)
        bench_case("planar", build_planar_planning, args.restarts,
                   args.niters, methods)
    if "point3d" in args.cases:
        print(f"3-D point planning (N=20, s=6, B={args.restarts}):",
              flush=True)
        bench_case("point3d", build_point3d_planning, args.restarts,
                   args.niters, methods)


if __name__ == "__main__":
    main()
