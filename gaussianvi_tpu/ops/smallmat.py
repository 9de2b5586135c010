"""Unrolled small-matrix SPD algebra (batched, fusable, loop-free).

XLA's ``cholesky`` / ``cho_solve`` lower to blocked while-loops with dynamic
slices — correct for big matrices, latency-bound for the tiny (s <= 8) state
blocks this framework lives on (steady-state profiling showed the batched
4x4 factorizations dominating each line-search trial, not the chain kernel).
These routines unroll the Cholesky-Banachiewicz recurrences over the static
matrix dimension into pure elementwise ops on the batch, which XLA fuses
into the surrounding computation — the same trick the Pallas chain kernel
uses internally (kernels/chain_block.py), applied at the XLA level so every
caller (sigma-point placement, marginal precisions, the seq chain backend)
benefits on any backend.

All functions fall back to the LAPACK-style primitives above ``_MAX_UNROLL``
(high-dimensional quadrature tests go to d=20 where unrolling would bloat
the program).  Entries are plain jnp ops, so autodiff works through them.
"""

from __future__ import annotations

import jax.numpy as jnp

_MAX_UNROLL = 8


def _entries(a, s):
    """[..., s, s] -> list-of-lists of [...] entry arrays."""
    return [[a[..., i, j] for j in range(s)] for i in range(s)]


def _stack(rows):
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def _chol_entries(a, s):
    """Lower Cholesky factor entries of SPD entries ``a`` (unrolled)."""
    l = [[None] * s for _ in range(s)]
    for j in range(s):
        acc = a[j][j]
        for k in range(j):
            acc = acc - l[j][k] * l[j][k]
        ljj = jnp.sqrt(acc)
        l[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, s):
            acc = a[i][j]
            for k in range(j):
                acc = acc - l[i][k] * l[j][k]
            l[i][j] = acc * inv
    return l


def _chol_solve_entries(l, b, s):
    """Solve (L L^T) x = b for one entry-vector b (length s)."""
    y = [None] * s
    for i in range(s):
        acc = b[i]
        for k in range(i):
            acc = acc - l[i][k] * y[k]
        y[i] = acc / l[i][i]
    x = [None] * s
    for i in reversed(range(s)):
        acc = y[i]
        for k in range(i + 1, s):
            acc = acc - l[k][i] * x[k]
        x[i] = acc / l[i][i]
    return x


def chol_small(a: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky of batched SPD [..., s, s]; unrolled for s <= 8."""
    s = a.shape[-1]
    if s > _MAX_UNROLL:
        return jnp.linalg.cholesky(a)
    l = _chol_entries(_entries(a, s), s)
    zero = jnp.zeros_like(l[0][0])
    return _stack(
        [[l[i][j] if j <= i else zero for j in range(s)] for i in range(s)]
    )


def chol_solve_small(l: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L^T) x = b given the lower factor; b [..., s] or [..., s, m]."""
    s = l.shape[-1]
    if s > _MAX_UNROLL:
        from jax.scipy.linalg import cho_solve

        return cho_solve((l, True), b)
    le = _entries(l, s)
    if b.ndim == l.ndim:  # matrix rhs [..., s, m]
        m = b.shape[-1]
        cols = []
        for col in range(m):
            rhs = [b[..., i, col] for i in range(s)]
            cols.append(_chol_solve_entries(le, rhs, s))
        return _stack(
            [[cols[col][i] for col in range(m)] for i in range(s)]
        )
    rhs = [b[..., i] for i in range(s)]
    return jnp.stack(_chol_solve_entries(le, rhs, s), axis=-1)


def spd_solve_small(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """x = A^{-1} b for batched SPD A [..., s, s]."""
    s = a.shape[-1]
    if s > _MAX_UNROLL:
        from jax.scipy.linalg import cho_factor, cho_solve

        return cho_solve(cho_factor(a, lower=True), b)
    return chol_solve_small(chol_small(a), b)


def spd_inv_small(a: jnp.ndarray) -> jnp.ndarray:
    """Inverse of batched SPD [..., s, s]."""
    s = a.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(s, dtype=a.dtype), a.shape)
    return spd_solve_small(a, eye)


def logdet_spd_small(a: jnp.ndarray) -> jnp.ndarray:
    """log det of batched SPD [..., s, s] via the unrolled factor."""
    l = chol_small(a)
    return 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(l, axis1=-2, axis2=-1)), axis=-1
    )
