"""Chain-backend micro-benchmark on the GPU: ``seq`` scans vs ``assoc``
log-depth scans vs the Pallas chain kernel (kernels/chain_block.py), for
the GBP covariance + log det and the block-Thomas solve, on random SPD
block-tridiagonal batches.  Also reports each backend's error against a
float64 host oracle on the first 64 problems.

    python scripts/micro_bench.py --batch 2048 11264 --states 32 128 \
        --blocks 32 64 128

Prints one line per (operation, shape, backend): median of ``--repeats``
timed runs after a warm-up call, synchronised with block_until_ready.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from gaussianvi_tpu.ops.chain_oracle import (
    chain_errors,
    dense_oracle,
    random_chain,
)


def median_ms(fn, *args, repeats=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def backends(blocks):
    """name -> (cov fn [B,...] -> (cd, co, ld), solve fn) for each backend."""
    from gaussianvi_tpu.kernels import chain_block as kb
    from gaussianvi_tpu.ops.blocktridiag import (
        BlockTridiag, gbp_covariance_logdet, solve,
    )
    from gaussianvi_tpu.ops.parallel_chain import (
        gbp_covariance_logdet_assoc, solve_assoc,
    )

    def vm(cov, slv):
        return (
            jax.jit(jax.vmap(lambda d, o: cov(BlockTridiag(d, o)))),
            jax.jit(jax.vmap(lambda d, o, r: slv(
                BlockTridiag(d, o), r.reshape(-1)).reshape(r.shape))),
        )

    out = {"seq": vm(gbp_covariance_logdet, solve),
           "assoc": vm(gbp_covariance_logdet_assoc, solve_assoc)}
    for blk in blocks:
        out[f"kernel/{blk}"] = (
            jax.jit(lambda d, o, blk=blk: kb.gbp_covariance_logdet_kernel(
                d, o, block=blk)),
            jax.jit(lambda d, o, r, blk=blk: kb.solve_kernel(
                d, o, r, block=blk)),
        )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[2048, 11264])
    ap.add_argument("--states", type=int, nargs="+", default=[32, 128])
    ap.add_argument("--dim", type=int, default=4)
    ap.add_argument("--blocks", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit("micro_bench measures the GPU; no GPU found")
    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    fns = backends(args.blocks)
    s = args.dim
    for n in args.states:
        for b in args.batch:
            diag, off, rhs = random_chain(b, n, s, seed=b + n,
                                          dtype=np.float32)
            ref = dense_oracle(diag[:64], off[:64], rhs[:64])
            dj, oj, rj = (jnp.asarray(x) for x in (diag, off, rhs))
            for name, (cov, slv) in fns.items():
                t0 = time.perf_counter()
                got = (*cov(dj, oj), slv(dj, oj, rj))
                jax.block_until_ready(got)
                compile_s = time.perf_counter() - t0
                rel, ld = chain_errors([np.asarray(g[:64]) for g in got],
                                       ref)
                t_cov = median_ms(cov, dj, oj, repeats=args.repeats)
                t_slv = median_ms(slv, dj, oj, rj, repeats=args.repeats)
                print(f"B={b} N={n} s={s} {name:10s} cov+logdet "
                      f"{t_cov:8.3f} ms  solve {t_slv:8.3f} ms  "
                      f"rel err {rel:.2e}  logdet err/state {ld:.2e}  "
                      f"(first call {compile_s:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
