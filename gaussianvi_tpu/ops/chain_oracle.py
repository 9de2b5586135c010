"""Float64 host oracle for the chain backends: random SPD block-tridiagonal
batches and their dense inverse, log det and solve (numpy only).  Used by
the tests, ``scripts/micro_bench.py`` and ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np


def random_chain(b, n, s, seed=0, dtype=np.float64):
    """b random SPD (diagonally dominant) block-tridiagonal systems:
    diag [b,n,s,s], off [b,n-1,s,s], rhs [b,n,s]."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, s, s))
    diag = a @ np.swapaxes(a, -1, -2) + 3.0 * s * np.eye(s)
    off = 0.5 * rng.standard_normal((b, max(n - 1, 0), s, s))
    rhs = rng.standard_normal((b, n, s))
    return diag.astype(dtype), off.astype(dtype), rhs.astype(dtype)


def dense_oracle(diag, off, rhs):
    """(cov_diag, cov_off, logdet, x) of each system from its dense f64
    matrix."""
    diag, off, rhs = (np.asarray(x, np.float64) for x in (diag, off, rhs))
    b, n, s = diag.shape[:3]
    cds, cos, lds, xs = [], [], [], []
    for k in range(b):
        dense = np.zeros((n * s, n * s))
        for i in range(n):
            dense[i * s:(i + 1) * s, i * s:(i + 1) * s] = diag[k, i]
        for i in range(n - 1):
            dense[i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s] = off[k, i]
            dense[(i + 1) * s:(i + 2) * s, i * s:(i + 1) * s] = off[k, i].T
        inv = np.linalg.inv(dense)
        blk = lambda i, j: inv[i * s:(i + 1) * s, j * s:(j + 1) * s]
        cds.append([blk(i, i) for i in range(n)])
        cos.append(np.reshape([blk(i, i + 1) for i in range(n - 1)],
                              (n - 1, s, s)))
        lds.append(np.linalg.slogdet(dense)[1])
        xs.append(np.linalg.solve(dense, rhs[k].reshape(-1)).reshape(n, s))
    return (np.asarray(cds), np.asarray(cos), np.asarray(lds),
            np.asarray(xs))


def chain_errors(got, ref):
    """(max normwise relative error over cov_diag / cov_off / x, max
    absolute logdet error per state) of ``got`` against ``ref``, both
    (cov_diag, cov_off, logdet, x)."""
    n = ref[0].shape[1]
    rel = max(
        float(np.abs(np.asarray(g, np.float64).reshape(r.shape) - r).max()
              / max(np.abs(r).max(), 1e-300))
        for g, r in ((got[0], ref[0]), (got[1], ref[1]), (got[3], ref[3]))
        if r.size
    )
    ld = float(np.abs(np.asarray(got[2], np.float64) - ref[2]).max()) / n
    return rel, ld
