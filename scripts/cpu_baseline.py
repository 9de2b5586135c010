"""Compiled-CPU baseline: reference-equivalent C++/OpenMP NGD.

The reference's own binary needs Eigen 3.4 (CMakeLists.txt:44-45), which
is not a dependency of this repository.  What CAN be measured is a
faithful compiled C++/OpenMP implementation of the same NGD algorithm on
the same problems (csrc/cpu_baseline.cpp): f64 throughout (the reference is
all MatrixXd), per-factor sigma-point quadrature from the same sparse-GH
rule, GBP chain covariance + logdet, closed-form linear gradients,
block-Thomas natural-gradient solve, and the reference's SEQUENTIAL
backtracking shrink loop (early exit at the first accepted trial — which
FAVORS the CPU baseline over the engine's evaluate-all-trials lockstep), with
`#pragma omp parallel for` over problems (the batch analog of the
reference's factor-level OMP fan-out, ngd/NGD-GH-impl.h:31-51).

This script exports the EXACT bench problems (bench.py build_batch), builds
the C++ with g++ -O3 -march=native -fopenmp, runs it, and reports
prob-iters/s for the bench operating points.

    python scripts/cpu_baseline.py [B ...]
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def export_problems(path: str, num_problems: int, num_states=32, dim_x=2,
                    gh_degree=4):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from bench import build_batch

    graph_b, state_b = build_batch(num_problems, num_states, dim_x, gh_degree)
    g0 = graph_b
    meas = g0.nonlinear[0]
    anchor, gp = g0.linear
    # stacked problem batches carry a leading B axis on every leaf; the
    # quadrature rule is shared, take problem 0's copy
    nodes = np.asarray(meas.nodes, np.float64)
    weights = np.asarray(meas.weights, np.float64)
    if nodes.ndim == 3:
        nodes, weights = nodes[0], weights[0]
    b, n, s = np.asarray(state_b.mu).shape
    m = nodes.shape[0]

    with open(path, "wb") as f:
        f.write(struct.pack("<6q", b, n, s, m, 10, 11))  # niters, ntrials
        # base, decay, T, high T (GVIConfig defaults + bench step base)
        f.write(struct.pack("<4d", 0.9, 0.75, 1.0, 10.0))

        def w(arr):
            f.write(np.ascontiguousarray(arr, np.float64).tobytes())

        w(nodes)                                   # [M, s]
        w(weights)                                 # [M]
        w(np.asarray(state_b.mu))                  # [B, N, s]
        w(np.asarray(state_b.precision.diag))      # [B, N, s, s]
        w(np.asarray(state_b.precision.off))       # [B, N-1, s, s]
        # anchor (K=1, nb=1): lam [1,s,s], tmu via psi@target_mu, tprec, C
        pm_a = np.einsum(
            "bkrt,bkt->bkr", np.asarray(anchor.psi),
            np.asarray(anchor.target_mu),
        )
        w(np.asarray(anchor.lam)[:, 0])            # [B, s, s]
        w(pm_a[:, 0])                              # [B, s]
        w(np.asarray(anchor.target_prec)[:, 0])    # [B, s, s]
        w(np.asarray(anchor.constant)[:, 0])       # [B]
        # min-acc edges (uniform rows): lam [s, 2s], tprec [s, s], C
        w(np.asarray(gp.lam)[:, 0])                # [B, s, 2s]
        w(np.asarray(gp.target_prec)[:, 0])        # [B, s, s]
        w(np.asarray(gp.constant)[:, 0])           # [B]
        # range measurement params per state
        p = meas.params
        w(np.asarray(p["r"]))                      # [B, N]
        w(np.asarray(p["beacon"]))                 # [B, N, dim_x]
        w(np.asarray(p["sig_r_sq"]))               # [B, N]
        f.write(struct.pack("<q", np.asarray(p["beacon"]).shape[-1]))
    return b, n, s, m


def build_binary():
    root = Path(__file__).resolve().parent.parent
    src = root / "csrc" / "cpu_baseline.cpp"
    out = root / "csrc" / "cpu_baseline"
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-std=c++17",
           str(src), "-o", str(out)]
    subprocess.run(cmd, check=True)
    return out


def main():
    sizes = [int(a) for a in sys.argv[1:] if not a.startswith("-")] or [64]
    binary = build_binary()
    for b in sizes:
        path = f"/tmp/cpu_baseline_{b}.bin"
        export_problems(path, b)
        env = dict(os.environ, OMP_NUM_THREADS=str(os.cpu_count()))
        t0 = time.perf_counter()
        out = subprocess.run(
            [str(binary), path], check=True, capture_output=True, text=True,
            env=env,
        )
        print(f"B={b}: {out.stdout.strip()} "
              f"(wall incl. load {time.perf_counter() - t0:.1f}s, "
              f"{os.cpu_count()} threads)", flush=True)


if __name__ == "__main__":
    main()
