"""Pallas (Triton route) chain kernels: GBP covariance + log det, and the
block-Thomas solve, for a batch of block-tridiagonal SPD systems.

As ``lax.scan`` programs the chain recurrences are N sequential steps of
tiny s x s fusions, so on a GPU they are bound by launches and latency,
not by bytes.  Here one program instance (a Triton block) owns ``block``
problems for the whole chain: one problem per thread, the forward and
backward sweeps are loops inside the kernel, and the s x s algebra is
unrolled statically over vectors of the block's problems.

Layout: the batch is the LAST axis (``[N, s, s, B]``), so every load of one
matrix entry for the block's problems is one coalesced ``(block,)`` vector
-- the only shape the kernel ever loads, stores or computes with (Triton
wants power-of-two sizes, so nothing of shape s or N is ever held as an
array).  The grid covers the batch only; blocks are independent.  Forward
pivots (and the solve's eliminated right-hand side) go to an extra output
in device memory that the backward sweep of the same thread reads back.

Outputs match :func:`..ops.blocktridiag.gbp_covariance_logdet` and
:func:`..ops.blocktridiag.solve` per problem, including the pivot-trust
NaN guard on the log det.  Nothing differentiates through these ops (the
samplers differentiate only the pointwise target), so there is no
gradient rule.  ``interpret=True`` runs the kernels on the CPU for tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Largest state-block dimension the kernels accept.  The unrolled s x s
# algebra keeps O(s^2) values per thread in registers; s = 4 (the
# estimation and point-robot planning states) fits.
MAX_STATE_DIM = 4

# Problems per program instance (one per thread) -- see PERF.md.
DEFAULT_BLOCK = 32


# -- unrolled small-matrix algebra on lists of [block]-vector entries --------

def _chol(a, s):
    """Lower Cholesky of an s x s SPD matrix a[i][j] -> L[i][j]."""
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


def _chol_solve_vec(l, b, s):
    """Solve (L L^T) x = b for one vector b[i]."""
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


def _chol_solve_mat(l, b, s, transpose_b=False):
    """Solve (L L^T) X = B (or B^T) column by column."""
    x = [[None] * s for _ in range(s)]
    for col in range(s):
        rhs = [b[col][r] if transpose_b else b[r][col] for r in range(s)]
        sol = _chol_solve_vec(l, rhs, s)
        for r in range(s):
            x[r][col] = sol[r]
    return x


def _matmul(a, b, s, transpose_a=False):
    """c[i][j] = sum_k a[i][k] b[k][j] (or a[k][i] when transposed)."""
    c = [[None] * s for _ in range(s)]
    for i in range(s):
        for j in range(s):
            acc = None
            for k in range(s):
                term = (a[k][i] if transpose_a else a[i][k]) * b[k][j]
                acc = term if acc is None else acc + term
            c[i][j] = acc
    return c


def _dot(u, v):
    acc = u[0] * v[0]
    for a, b in zip(u[1:], v[1:]):
        acc = acc + a * b
    return acc


def _logdet_from_chol(l, s):
    acc = jnp.log(l[0][0])
    for j in range(1, s):
        acc = acc + jnp.log(l[j][j])
    return 2.0 * acc


def _pivot_trust(l, piv, d, m, s, trust):
    """Update the running minimum pivot-trust statistic.

    For each diagonal j of the Schur pivot ``piv = d + m`` with Cholesky
    ``l``:  numer = L_jj^2 (the surviving pivot mass) against
    denom = |d_jj| + |m_jj| + |piv_jj - L_jj^2| (everything that cancelled
    to produce it).  When numer/denom falls to a few eps the pivot is
    rounding noise: the matrix lost positive-definiteness at working
    precision and the log det is garbage, so it is poisoned with NaN and
    the line search rejects the trial, as the reference's f64 backtracking
    rejects non-SPD proposals (gvibase/GVI-GH-impl.h:79-118).  Same
    statistic as :func:`..ops.blocktridiag._guarded_logdet`.
    """
    for j in range(s):
        numer = l[j][j] * l[j][j]
        denom = jnp.abs(d[j][j]) + jnp.abs(m[j][j]) + jnp.abs(piv[j][j] - numer)
        trust = jnp.minimum(trust, numer / denom)
    return trust


def _trust_tol(dtype) -> float:
    # 8 eps: trips only when fewer than ~3 significant bits survive the
    # cancellation, while legitimate ill-conditioning passes untouched
    return 8.0 * float(jnp.finfo(dtype).eps)


# -- ref access: one (block,) vector per matrix entry --------------------------

def _load_mat(ref, i, s):
    return [[ref[i, a, b, :] for b in range(s)] for a in range(s)]


def _store_mat(ref, i, mat, s):
    for a in range(s):
        for b in range(s):
            ref[i, a, b, :] = mat[a][b]


def _add(x, y, s):
    return [[x[a][b] + y[a][b] for b in range(s)] for a in range(s)]


def _neg(x, s):
    return [[-x[a][b] for b in range(s)] for a in range(s)]


def _flat(mat):
    return tuple(v for row in mat for v in row)


def _unflat(vals, s):
    return [list(vals[a * s:(a + 1) * s]) for a in range(s)]


# -- kernels -------------------------------------------------------------------

def _inverse(l, s, zero, one):
    """(L L^T)^{-1} from the Cholesky factor, column by column."""
    eye = [[one if r == c else zero for c in range(s)] for r in range(s)]
    return _chol_solve_mat(l, eye, s)


def _gbp_kernel(n, s, d_ref, o_ref, covd_ref, covo_ref, ld_ref, fpiv_ref):
    """Forward sweep: pivots F_i = D_i + f_i (stored) and the guarded log
    det; Sigma_{n-1} = F_{n-1}^{-1}.  Backward sweep over edges i = n-2..0
    with the backward message m into state i+1: G = D_{i+1} + m,
    X = G^{-1} B_i^T, the message into i is -B_i X, and the blocks of the
    edge's joint inverse [[F_i, B_i], [B_i^T, G]]^{-1} are
    Sigma_i = (F_i - B_i X)^{-1} and Sigma_{i,i+1} = -Sigma_i X^T."""
    zero = jnp.zeros_like(d_ref[0, 0, 0, :])
    one = jnp.ones_like(zero)
    zeros_m = [[zero] * s for _ in range(s)]
    tol = _trust_tol(d_ref.dtype)

    def pivot(i, m, ld, comp, trust):
        # pivot of state i; log det accumulated Kahan-compensated, since it
        # feeds line-search accept decisions
        d = _load_mat(d_ref, i, s)
        piv = _add(d, m, s)
        _store_mat(fpiv_ref, i, piv, s)
        l = _chol(piv, s)
        trust = _pivot_trust(l, piv, d, m, s, trust)
        term = _logdet_from_chol(l, s) - comp
        ld_new = ld + term
        comp = (ld_new - ld) - term
        return l, ld_new, comp, trust

    def fwd_body(i, carry):
        m_flat, ld, comp, trust = carry
        l, ld, comp, trust = pivot(i, _unflat(m_flat, s), ld, comp, trust)
        off = _load_mat(o_ref, i, s)
        m_next = _neg(_matmul(off, _chol_solve_mat(l, off, s), s,
                              transpose_a=True), s)
        return _flat(m_next), ld, comp, trust

    m_flat, ld, comp, trust = _flat(zeros_m), zero, zero, one
    if n > 1:
        m_flat, ld, comp, trust = jax.lax.fori_loop(
            0, n - 1, fwd_body, (m_flat, ld, comp, trust)
        )
    l_last, ld, _, trust = pivot(n - 1, _unflat(m_flat, s), ld, comp, trust)
    ld_ref[:] = jnp.where(trust >= tol, ld, jnp.full_like(ld, jnp.nan))
    _store_mat(covd_ref, n - 1, _inverse(l_last, s, zero, one), s)

    def bwd_body(k, m_flat):
        i = n - 2 - k
        g = _add(_load_mat(d_ref, i + 1, s), _unflat(m_flat, s), s)
        off = _load_mat(o_ref, i, s)
        x = _chol_solve_mat(_chol(g, s), off, s, transpose_b=True)
        m_prev = _neg(_matmul(off, x, s), s)
        sig = _inverse(_chol(_add(_load_mat(fpiv_ref, i, s), m_prev, s), s),
                       s, zero, one)
        _store_mat(covd_ref, i, sig, s)
        # Sigma_{i,i+1}[a][b] = -sum_c Sigma_i[a][c] X[b][c]
        _store_mat(covo_ref, i, [[-_dot(sig[a], x[b]) for b in range(s)]
                                 for a in range(s)], s)
        return _flat(m_prev)

    if n > 1:
        jax.lax.fori_loop(0, n - 1, bwd_body, _flat(zeros_m))


def _solve_kernel(n, s, d_ref, o_ref, b_ref, x_ref, fpiv_ref, y_ref):
    """Block Thomas: forward pivots F_i and eliminated rhs
    y_i = b_i - B_{i-1}^T F_{i-1}^{-1} y_{i-1} (both stored), then
    x_i = F_i^{-1} (y_i - B_i x_{i+1}) backwards."""
    zero = jnp.zeros_like(d_ref[0, 0, 0, :])

    def fwd_body(i, carry):
        m_flat, z = carry
        piv = _add(_load_mat(d_ref, i, s), _unflat(m_flat, s), s)
        _store_mat(fpiv_ref, i, piv, s)
        y = [b_ref[i, r, :] - z[r] for r in range(s)]
        for r in range(s):
            y_ref[i, r, :] = y[r]
        l = _chol(piv, s)
        off = _load_mat(o_ref, i, s)
        g = _chol_solve_mat(l, off, s)                      # F_i^{-1} B_i
        m_next = _neg(_matmul(off, g, s, transpose_a=True), s)
        fy = _chol_solve_vec(l, y, s)                       # F_i^{-1} y_i
        z_next = tuple(_dot([off[k][r] for k in range(s)], fy)
                       for r in range(s))                   # B_i^T F_i^{-1} y_i
        return _flat(m_next), z_next

    carry = (tuple([zero] * (s * s)), tuple([zero] * s))
    if n > 1:
        carry = jax.lax.fori_loop(0, n - 1, fwd_body, carry)
    m_flat, z = carry
    piv = _add(_load_mat(d_ref, n - 1, s), _unflat(m_flat, s), s)
    y = [b_ref[n - 1, r, :] - z[r] for r in range(s)]
    x_last = _chol_solve_vec(_chol(piv, s), y, s)
    for r in range(s):
        x_ref[n - 1, r, :] = x_last[r]

    def bwd_body(k, x_next):
        i = n - 2 - k
        l = _chol(_load_mat(fpiv_ref, i, s), s)
        off = _load_mat(o_ref, i, s)
        rhs = [y_ref[i, r, :] - _dot(off[r], x_next) for r in range(s)]
        x = _chol_solve_vec(l, rhs, s)
        for r in range(s):
            x_ref[i, r, :] = x[r]
        return tuple(x)

    if n > 1:
        jax.lax.fori_loop(0, n - 1, bwd_body, tuple(x_last))


# -- wrappers ------------------------------------------------------------------

def _sds(shape, dtype, like):
    """ShapeDtypeStruct carrying the varying-manual-axes type of ``like``:
    under ``shard_map(check_vma=True)`` a pallas_call must declare how its
    outputs vary over the mesh -- exactly like the operands."""
    vma = getattr(jax.typeof(like), "vma", None)
    if vma:
        return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
    return jax.ShapeDtypeStruct(shape, dtype)


def _check_shapes(s: int, block: int) -> None:
    if s > MAX_STATE_DIM:
        raise ValueError(
            f"chain kernel supports state dim <= {MAX_STATE_DIM}, got {s}"
        )
    if block < 1 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")


def _pad_batch(diag, off, block, *rest):
    """Pad the batch to a multiple of ``block`` with identity systems (and
    zero right-hand sides) so every program instance is full."""
    b, n, s, _ = diag.shape
    pad = (-b) % block
    if not pad:
        return (diag, off) + rest
    eye = jnp.broadcast_to(jnp.eye(s, dtype=diag.dtype), (pad, n, s, s))
    diag = jnp.concatenate([diag, eye])
    off = jnp.concatenate([off, jnp.zeros((pad,) + off.shape[1:], off.dtype)])
    rest = tuple(
        jnp.concatenate([r, jnp.zeros((pad,) + r.shape[1:], r.dtype)])
        for r in rest
    )
    return (diag, off) + rest


def _batch_last(x):
    return jnp.moveaxis(x, 0, -1)


def _call(kernel, args, out_shapes, block, interpret):
    """pallas_call gridded over the trailing batch axis only."""

    def spec(shape):
        lead = (0,) * (len(shape) - 1)
        return pl.BlockSpec(shape[:-1] + (block,), lambda g: lead + (g,))

    grid = args[0].shape[-1] // block
    return pl.pallas_call(
        kernel,
        grid=(grid,),
        in_specs=[spec(a.shape) for a in args],
        out_specs=[spec(o.shape) for o in out_shapes],
        out_shape=out_shapes,
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1
        ),
        interpret=interpret,
    )(*args)


def gbp_covariance_logdet_kernel(
    diag: jnp.ndarray, off: jnp.ndarray, *, block: int = DEFAULT_BLOCK,
    interpret: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched GBP covariance + log det: diag [B,N,s,s], off [B,N-1,s,s]
    -> (cov_diag [B,N,s,s], cov_off [B,N-1,s,s], logdet [B])."""
    b, n, s, _ = diag.shape
    _check_shapes(s, block)
    if n == 1:
        off = jnp.zeros((b, 1, s, s), diag.dtype)   # never read
    diag, off = _pad_batch(diag, off, block)
    d_t, o_t = _batch_last(diag), _batch_last(off)
    bp, dt = d_t.shape[-1], diag.dtype
    covd, covo, ld, _ = _call(
        functools.partial(_gbp_kernel, n, s), (d_t, o_t),
        [_sds(d_t.shape, dt, d_t), _sds(o_t.shape, dt, d_t),
         _sds((bp,), dt, d_t), _sds(d_t.shape, dt, d_t)],
        block, interpret,
    )
    cov_off = jnp.moveaxis(covo, -1, 0)[:b]
    if n == 1:
        cov_off = cov_off[:, :0]
    return jnp.moveaxis(covd, -1, 0)[:b], cov_off, ld[:b]


def solve_kernel(
    diag: jnp.ndarray, off: jnp.ndarray, rhs: jnp.ndarray, *,
    block: int = DEFAULT_BLOCK, interpret: bool = False,
) -> jnp.ndarray:
    """Batched SPD block-tridiagonal solve: diag [B,N,s,s], off
    [B,N-1,s,s], rhs [B,N,s] -> x [B,N,s]."""
    b, n, s, _ = diag.shape
    _check_shapes(s, block)
    if n == 1:
        off = jnp.zeros((b, 1, s, s), diag.dtype)   # never read
    diag, off, rhs = _pad_batch(diag, off, block, rhs)
    d_t, o_t, r_t = _batch_last(diag), _batch_last(off), _batch_last(rhs)
    dt = diag.dtype
    x, _, _ = _call(
        functools.partial(_solve_kernel, n, s), (d_t, o_t, r_t),
        [_sds(r_t.shape, dt, d_t), _sds(d_t.shape, dt, d_t),
         _sds(r_t.shape, dt, d_t)],
        block, interpret,
    )
    return jnp.moveaxis(x, -1, 0)[:b]


# -- single-problem drop-ins whose vmaps land on the kernel's batch axis -------
# pallas_call's generic batching rule would add a grid axis per vmap; these
# custom rules instead FLATTEN every outer vmap axis (problems x line-search
# trials) into the kernel's batch axis.

def _ensure_batched(axis_size, x, batched):
    return x if batched else jnp.broadcast_to(x[None], (axis_size,) + x.shape)


@jax.custom_batching.custom_vmap
def _cov_batched(diag, off):
    return gbp_covariance_logdet_kernel(diag, off)


@_cov_batched.def_vmap
def _cov_batched_rule(axis_size, in_batched, diag, off):
    diag = _ensure_batched(axis_size, diag, in_batched[0])
    off = _ensure_batched(axis_size, off, in_batched[1])
    b2, b, n, s = diag.shape[:4]
    cd, co, ld = _cov_batched(
        diag.reshape(b2 * b, n, s, s), off.reshape(b2 * b, n - 1, s, s)
    )
    out = (
        cd.reshape(b2, b, n, s, s),
        co.reshape(b2, b, n - 1, s, s),
        ld.reshape(b2, b),
    )
    return out, (True, True, True)


@jax.custom_batching.custom_vmap
def _solve_batched(diag, off, rhs):
    return solve_kernel(diag, off, rhs)


@_solve_batched.def_vmap
def _solve_batched_rule(axis_size, in_batched, diag, off, rhs):
    diag = _ensure_batched(axis_size, diag, in_batched[0])
    off = _ensure_batched(axis_size, off, in_batched[1])
    rhs = _ensure_batched(axis_size, rhs, in_batched[2])
    b2, b, n, s = diag.shape[:4]
    x = _solve_batched(
        diag.reshape(b2 * b, n, s, s),
        off.reshape(b2 * b, n - 1, s, s),
        rhs.reshape(b2 * b, n, s),
    )
    return x.reshape(b2, b, n, s), True


def gbp_covariance_logdet_single(precision):
    """Drop-in for ops.blocktridiag.gbp_covariance_logdet on ONE problem;
    efficient under outer vmaps, which flatten onto the kernel batch."""
    cd, co, ld = _cov_batched(precision.diag[None], precision.off[None])
    return cd[0], co[0], ld[0]


def solve_single(precision, b):
    """Drop-in for ops.blocktridiag.solve on one problem (flat rhs [N*s])."""
    n, s = precision.diag.shape[0], precision.diag.shape[-1]
    x = _solve_batched(
        precision.diag[None], precision.off[None], b.reshape(1, n, s)
    )
    return x[0].reshape(b.shape)
