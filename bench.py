"""Benchmark: NGD problem-iterations/s on the batch state-estimation flagship.

Workload: B independent trajectory-estimation problems, each N states of
dim 4 ([pos2; vel2]), minimum-acc GP priors + anchor + nonlinear range
measurements on the degree-4 position-marginal rule, full NGD iterations
including the 11-trial backtracking line search (``GVIConfig`` defaults
for every implementation choice, resolved per platform).  Data are
float32; the engine runs the chain recurrences in float64
(``ops.blocktridiag.in_float64``), so 64-bit types are enabled.

``value`` is the rate at B=1024/N=32 on the first GPU; ``vs_baseline``
compares the B=64 rate with the same engine on the host CPU.  Each rate is
B x niters over the median of timed runs, each ending in
``jax.block_until_ready``.  Needs a GPU; prints one JSON line on stdout and
the device on stderr.

    python bench.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import jax


def build_batch(num_problems, num_states, dim_x, gh_degree, dtype=None):
    from gaussianvi_tpu.examples.chain_estimation import build_chain_estimation
    from gaussianvi_tpu.parallel.sharding import stack_problems

    graphs, states = [], []
    for seed in range(num_problems):
        graph, init, _ = build_chain_estimation(
            num_states=num_states, dim_x=dim_x, gh_degree=gh_degree,
            seed=seed, dtype=dtype,
        )
        graphs.append(graph)
        states.append(init)
    return stack_problems(graphs, states)


def bench_device(device, num_problems=64, num_states=32, dim_x=2,
                 gh_degree=4, niters=10, repeats=5, method="ngd"):
    """prob-iters/s of jit(vmap(optimize)) on ``device``."""
    import jax.numpy as jnp

    from gaussianvi_tpu.inference import GVIConfig
    from gaussianvi_tpu.inference.optimize import optimize

    config = GVIConfig(niters=niters, niters_lowtemp=niters,
                       step_size_base=0.9)
    with jax.default_device(device):
        graph_b, state_b = jax.device_put(build_batch(
            num_problems, num_states, dim_x, gh_degree, dtype=jnp.float32
        ), device)
        run = jax.jit(
            jax.vmap(lambda g, s: optimize(g, s, config, method=method)[0])
        )
        out = jax.block_until_ready(run(graph_b, state_b))  # compile
        if not bool(jnp.isfinite(out.mu).all()):
            raise FloatingPointError("non-finite final means")
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run(graph_b, state_b))
            times.append(time.perf_counter() - t0)
        return num_problems * niters / statistics.median(times)


def main():
    from gaussianvi_tpu.utils.compile_cache import configure_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit("bench.py measures the GPU; JAX found none")
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache()
    device = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[bench] platform {device.platform}, {device.device_kind}, "
          f"{len(jax.devices())} device(s); card {card}", file=sys.stderr)

    t0 = time.perf_counter()
    rate_legacy = bench_device(device)
    print(f"[bench] B=64: {rate_legacy:.0f} prob-iters/s "
          f"({time.perf_counter() - t0:.0f} s)", file=sys.stderr)
    t0 = time.perf_counter()
    rate_dev = bench_device(device, num_problems=1024)
    print(f"[bench] B=1024: {rate_dev:.0f} prob-iters/s "
          f"({time.perf_counter() - t0:.0f} s)", file=sys.stderr)
    t0 = time.perf_counter()
    rate_prox = bench_device(device, num_problems=1024, method="prox")
    print(f"[bench] prox B=1024: {rate_prox:.0f} prob-iters/s "
          f"({time.perf_counter() - t0:.0f} s)", file=sys.stderr)
    t0 = time.perf_counter()
    rate_cpu = bench_device(jax.devices("cpu")[0], repeats=1)
    print(f"[bench] host CPU B=64: {rate_cpu:.0f} prob-iters/s "
          f"({time.perf_counter() - t0:.0f} s)", file=sys.stderr)

    print(json.dumps({
        "metric": "ngd_iters_per_sec_batch1024x32states",
        "value": round(rate_dev, 2),
        "unit": "iters/s",
        "vs_baseline": round(rate_legacy / rate_cpu, 3),
        "prox_iters_per_sec": round(rate_prox, 2),
    }))


if __name__ == "__main__":
    main()
