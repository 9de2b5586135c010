"""Block-tridiagonal symmetric matrices: the joint precision representation.

The reference stores the joint precision as an Eigen sparse matrix with a
block-tridiagonal nnz pattern (gvibase/GVI-GH.h:214-230) and computes

* the covariance blocks it needs by sparse-LDLT selected inversion
  (helpers/EigenWrapper.h:282-381) or by chain Gaussian belief propagation
  (gvibase/GVI-GH-GBP-impl.h:246-342), and
* the entropy term as ``0.5 * sum(log D_ii)`` of the LDLT
  (gvibase/GVI-GH-impl.h:192-196).

Design: a ``BlockTridiag`` pytree of two dense stacks ``diag [N, s, s]``
and ``off [N-1, s, s]`` (block (i, i+1)).  All chain recurrences here are
``lax.scan`` over the state axis with small dense blocks (the ``seq``
backend; ``ops/parallel_chain`` and ``kernels/chain_block`` are the others);
the per-edge 2s x 2s inversions of GBP are vmapped.  The dense D x D matrix is never materialized
except in tests.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax
from .smallmat import chol_small, logdet_spd_small, spd_inv_small, spd_solve_small
from .precision import einsum, matmul


def _match_vma(x: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """Give a fresh constant the device-variance type of ``ref`` so scan
    carries seeded with it type-check under shard_map (check_vma=True)."""
    want = getattr(jax.typeof(ref), "vma", frozenset())
    have = getattr(jax.typeof(x), "vma", frozenset())
    missing = tuple(want - have)
    if not missing:
        return x
    return lax.pcast(x, missing, to="varying")


def spd_solve(mat: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve ``mat @ x = rhs`` for symmetric positive-definite ``mat``.

    Cholesky-based; small blocks (s <= 8) go through the unrolled loop-free
    factorization in ops.smallmat (XLA's blocked cholesky/cho_solve are
    latency-bound at these sizes), larger ones through ``cho_solve``.
    """
    return spd_solve_small(mat, rhs)


def spd_inv(mat: jnp.ndarray) -> jnp.ndarray:
    """Inverse of an SPD matrix (batched ok) via Cholesky."""
    return spd_inv_small(mat)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockTridiag:
    """Symmetric block-tridiagonal matrix.

    diag: [N, s, s] diagonal blocks (each symmetric).
    off:  [N-1, s, s] super-diagonal blocks; block (i+1, i) is ``off[i].T``.
    """

    diag: jnp.ndarray
    off: jnp.ndarray

    @property
    def num_states(self) -> int:
        return self.diag.shape[0]

    @property
    def block_dim(self) -> int:
        return self.diag.shape[-1]

    @property
    def dim(self) -> int:
        return self.num_states * self.block_dim

    # -- constructors -------------------------------------------------------
    @staticmethod
    def zeros(num_states: int, block_dim: int, dtype=jnp.float64) -> "BlockTridiag":
        return BlockTridiag(
            jnp.zeros((num_states, block_dim, block_dim), dtype),
            jnp.zeros((max(num_states - 1, 0), block_dim, block_dim), dtype),
        )

    @staticmethod
    def identity(num_states: int, block_dim: int, scale=1.0, dtype=jnp.float64) -> "BlockTridiag":
        eye = jnp.broadcast_to(
            jnp.eye(block_dim, dtype=dtype) * scale,
            (num_states, block_dim, block_dim),
        )
        return BlockTridiag(
            eye, jnp.zeros((max(num_states - 1, 0), block_dim, block_dim), dtype)
        )

    @staticmethod
    def from_dense(mat: jnp.ndarray, num_states: int) -> "BlockTridiag":
        s = mat.shape[0] // num_states
        diag = jnp.stack(
            [mat[i * s:(i + 1) * s, i * s:(i + 1) * s] for i in range(num_states)]
        )
        if num_states > 1:
            off = jnp.stack(
                [mat[i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s]
                 for i in range(num_states - 1)]
            )
        else:
            off = jnp.zeros((0, s, s), mat.dtype)
        return BlockTridiag(diag, off)

    # -- algebra ------------------------------------------------------------
    def to_dense(self) -> jnp.ndarray:
        n, s = self.num_states, self.block_dim
        out = jnp.zeros((n * s, n * s), self.diag.dtype)
        for i in range(n):
            out = out.at[i * s:(i + 1) * s, i * s:(i + 1) * s].set(self.diag[i])
        for i in range(n - 1):
            out = out.at[i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s].set(self.off[i])
            out = out.at[(i + 1) * s:(i + 2) * s, i * s:(i + 1) * s].set(self.off[i].T)
        return out

    def __add__(self, other: "BlockTridiag") -> "BlockTridiag":
        return BlockTridiag(self.diag + other.diag, self.off + other.off)

    def __sub__(self, other: "BlockTridiag") -> "BlockTridiag":
        return BlockTridiag(self.diag - other.diag, self.off - other.off)

    def scale(self, c) -> "BlockTridiag":
        return BlockTridiag(self.diag * c, self.off * c)

    def symmetrize(self) -> "BlockTridiag":
        return BlockTridiag(
            0.5 * (self.diag + jnp.swapaxes(self.diag, -1, -2)), self.off
        )

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x for x flat [N*s] (or blocked [N, s])."""
        n, s = self.num_states, self.block_dim
        xb = x.reshape(n, s)
        y = einsum("nij,nj->ni", self.diag, xb)
        if n > 1:
            y = y.at[:-1].add(einsum("nij,nj->ni", self.off, xb[1:]))
            y = y.at[1:].add(einsum("nji,nj->ni", self.off, xb[:-1]))
        return y.reshape(x.shape)


def in_float64(fn):
    """``fn`` computed in float64 on float32 inputs, its float outputs cast
    back to float32; ``fn`` itself on float64 inputs.  The engines run
    every chain op through this, so float32 data need 64-bit types
    (``jax_enable_x64``); without them this raises rather than run the
    chain in float32.

    The chain recurrences are where a float32 run loses accuracy: the
    forward Schur pivots ``D_i - B^T F^{-1} B`` cancel, and the covariance
    blocks built on them move the line search's decisions, so float32
    trajectories drift from the float64 ones (PERF.md).  The arrays a chain
    op touches are small beside the quadrature's, so float64 here is
    cheap."""

    def wrapped(*args):
        if not any(getattr(x, "dtype", None) == jnp.float32
                   for x in jax.tree.leaves(args)):
            return fn(*args)
        if not jax.config.jax_enable_x64:
            raise ValueError(
                "the chain recurrences run in float64: enable 64-bit types "
                "(jax.config.update('jax_enable_x64', True)) before "
                "running the engine on float32 data"
            )
        up = jax.tree.map(
            lambda x: x.astype(jnp.float64)
            if getattr(x, "dtype", None) == jnp.float32 else x,
            args,
        )
        return jax.tree.map(
            lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x,
            fn(*up),
        )

    return wrapped


def block_cholesky(A: BlockTridiag) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Block LDL^T-style factorization of an SPD block-tridiagonal matrix.

    Returns ``(pivots [N, s, s], gains [N-1, s, s])`` with the Schur
    recurrence ``P_0 = D_0``, ``P_i = D_i - off_{i-1}^T P_{i-1}^{-1}
    off_{i-1}``; ``gains[i] = P_i^{-1} off_i`` feed the Thomas solve.
    """
    n, s = A.num_states, A.block_dim

    def step(prev_pivot, inputs):
        off_prev, d = inputs
        gain = spd_solve(prev_pivot, off_prev)  # P^{-1} B
        pivot = d - matmul(off_prev.T, gain)
        return pivot, (pivot, gain)

    p0 = A.diag[0]
    if n == 1:
        return p0[None], jnp.zeros((0, s, s), A.diag.dtype)
    _, (pivots_rest, gains) = lax.scan(step, p0, (A.off, A.diag[1:]))
    pivots = jnp.concatenate([p0[None], pivots_rest], axis=0)
    return pivots, gains


def logdet(A: BlockTridiag) -> jnp.ndarray:
    """log det of an SPD block-tridiagonal matrix via the pivot recurrence.

    Equals the reference's ``sum(log D_ii)`` over the scalar LDLT
    (gvibase/GVI-GH-impl.h:192-196).
    """
    pivots, _ = block_cholesky(A)
    return jnp.sum(logdet_spd_small(pivots))


def solve(A: BlockTridiag, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b (SPD block-tridiagonal) by the block Thomas algorithm.

    Replaces the reference's conjugate-gradient solve of the natural-gradient
    system (ngd/NGD-GH-impl.h:57-62) with an exact O(N s^3) direct solve.
    """
    n, s = A.num_states, A.block_dim
    bb = b.reshape(n, s)
    pivots, gains = block_cholesky(A)
    if n == 1:
        return spd_solve(pivots[0], bb[0]).reshape(b.shape)

    # forward eliminate: y_i = b_i - off_{i-1}^T P_{i-1}^{-1} y_{i-1}
    def fwd(carry, inputs):
        y_prev, p_prev = carry
        off_prev, b_i, p_i = inputs
        y_i = b_i - matmul(off_prev.T, spd_solve(p_prev, y_prev))
        return (y_i, p_i), y_i

    (_, _), ys_rest = lax.scan(fwd, (bb[0], pivots[0]), (A.off, bb[1:], pivots[1:]))
    ys = jnp.concatenate([bb[0][None], ys_rest], axis=0)

    # back substitute: x_N = P_N^{-1} y_N; x_i = P_i^{-1} y_i - gains_i x_{i+1}
    x_last = spd_solve(pivots[-1], ys[-1])

    def bwd(x_next, inputs):
        y_i, p_i, gain_i = inputs
        x_i = spd_solve(p_i, y_i) - matmul(gain_i, x_next)
        return x_i, x_i

    _, xs_rest = lax.scan(
        bwd, x_last, (ys[:-1], pivots[:-1], gains), reverse=True
    )
    xs = jnp.concatenate([xs_rest, x_last[None]], axis=0)
    return xs.reshape(b.shape)


def gbp_covariance(A: BlockTridiag) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Marginal covariance blocks of ``A^{-1}`` by chain belief propagation.

    Two ``lax.scan`` message sweeps with the Schur-complement message
    ``m_{i+1} = -B_i^T (D_i + m_i)^{-1} B_i`` (reference
    gvibase/GVI-GH-GBP-impl.h:282-342: the pairwise factor potential carries
    only off-diagonal blocks, so the generic factor message reduces to this),
    then one vmapped batch of 2s x 2s edge inversions.

    Returns ``(cov_diag [N, s, s], cov_off [N-1, s, s])`` — exactly the
    blocks the factors need; never the dense inverse.
    """
    n, s = A.num_states, A.block_dim
    if n == 1:
        return spd_inv(A.diag[0])[None], A.off

    def fwd_step(m, inputs):
        d, b_off = inputs
        m_next = -matmul(b_off.T, spd_solve(d + m, b_off))
        return m_next, m

    zero = _match_vma(jnp.zeros((s, s), A.diag.dtype), A.diag)
    # forward messages f_i into state i, i = 0..n-1 (f_0 = 0)
    f_last, f_head = lax.scan(fwd_step, zero, (A.diag[:-1], A.off))
    fwd_msgs = jnp.concatenate([f_head, f_last[None]], axis=0)

    def bwd_step(m, inputs):
        d, b_off = inputs
        m_prev = -matmul(b_off, spd_solve(d + m, b_off.T))
        return m_prev, m

    b_last, b_tail = lax.scan(
        bwd_step, zero, (A.diag[1:], A.off), reverse=True
    )
    bwd_msgs = jnp.concatenate([b_last[None], b_tail], axis=0)

    # per-edge joint precision [ [D_i + f_i, B_i], [B_i^T, D_{i+1} + b_{i+1}] ]
    top_left = A.diag[:-1] + fwd_msgs[:-1]
    bot_right = A.diag[1:] + bwd_msgs[1:]
    joint = jnp.concatenate(
        [
            jnp.concatenate([top_left, A.off], axis=2),
            jnp.concatenate([jnp.swapaxes(A.off, -1, -2), bot_right], axis=2),
        ],
        axis=1,
    )  # [n-1, 2s, 2s]
    joint_cov = spd_inv(joint)

    cov_diag = jnp.concatenate(
        [joint_cov[:, :s, :s], joint_cov[-1:, s:, s:]], axis=0
    )
    cov_off = joint_cov[:, :s, s:]
    return cov_diag, cov_off


def _guarded_logdet(pivots, diag, msgs):
    """Summed pivot logdet, NaN-poisoned when any Cholesky pivot has
    cancelled to rounding noise.

    trust_j = L_jj^2 / (|d_jj| + |m_jj| + sum_k L_jk^2): the surviving
    pivot mass against everything that cancelled to produce it (using
    sum_k L_jk^2 = piv_jj - L_jj^2).  Below ~8 eps the matrix has lost
    positive-definiteness at working precision and the "logdet" is
    garbage — returning NaN makes line searches REJECT such trials, the
    behavior the reference gets for free from f64 chol of indefinite
    proposals (f32 tiny-noise pivots instead produced
    hugely negative accepted "costs").  Mirrors the chain kernel's
    in-kernel guard (kernels/chain_block._pivot_trust).
    """
    l = chol_small(pivots)
    ldiag = jnp.diagonal(l, axis1=-2, axis2=-1)
    numer = ldiag * ldiag
    pdiag = jnp.diagonal(pivots, axis1=-2, axis2=-1)
    denom = (
        jnp.abs(jnp.diagonal(diag, axis1=-2, axis2=-1))
        + jnp.abs(jnp.diagonal(msgs, axis1=-2, axis2=-1))
        + jnp.abs(pdiag - numer)
    )
    trust = jnp.min(numer / denom)
    tol = 8.0 * jnp.finfo(pivots.dtype).eps
    ld = 2.0 * jnp.sum(jnp.log(ldiag))
    return jnp.where(trust >= tol, ld, jnp.full_like(ld, jnp.nan))


def gbp_covariance_logdet(
    A: BlockTridiag,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """GBP covariance blocks AND log det in one pass.

    The forward GBP pivots ``D_i + f_i`` are exactly the block-Cholesky
    pivots (same Schur recurrence), so log det = sum log det(D_i + f_i) —
    the cost path gets the entropy term without a second factorization
    sweep (the reference runs the LDLT separately, GVI-GH-impl.h:192-196).
    The logdet is NaN-poisoned for noise-level pivots (_guarded_logdet).
    """
    n, s = A.num_states, A.block_dim
    if n == 1:
        ld = _guarded_logdet(
            A.diag[0:1], A.diag[0:1], jnp.zeros_like(A.diag[0:1])
        )
        return spd_inv(A.diag[0])[None], A.off, ld

    def fwd_step(m, inputs):
        d, b_off = inputs
        m_next = -matmul(b_off.T, spd_solve(d + m, b_off))
        return m_next, m

    zero = _match_vma(jnp.zeros((s, s), A.diag.dtype), A.diag)
    f_last, f_head = lax.scan(fwd_step, zero, (A.diag[:-1], A.off))
    fwd_msgs = jnp.concatenate([f_head, f_last[None]], axis=0)

    pivots = A.diag + fwd_msgs
    ld = _guarded_logdet(pivots, A.diag, fwd_msgs)

    def bwd_step(m, inputs):
        d, b_off = inputs
        m_prev = -matmul(b_off, spd_solve(d + m, b_off.T))
        return m_prev, m

    b_last, b_tail = lax.scan(bwd_step, zero, (A.diag[1:], A.off), reverse=True)
    bwd_msgs = jnp.concatenate([b_last[None], b_tail], axis=0)

    top_left = pivots[:-1]
    bot_right = A.diag[1:] + bwd_msgs[1:]
    joint = jnp.concatenate(
        [
            jnp.concatenate([top_left, A.off], axis=2),
            jnp.concatenate([jnp.swapaxes(A.off, -1, -2), bot_right], axis=2),
        ],
        axis=1,
    )
    joint_cov = spd_inv(joint)
    cov_diag = jnp.concatenate(
        [joint_cov[:, :s, :s], joint_cov[-1:, s:, s:]], axis=0
    )
    cov_off = joint_cov[:, :s, s:]
    return cov_diag, cov_off, ld


def marginal_covariance_dense(A: BlockTridiag) -> jnp.ndarray:
    """Dense ``A^{-1}`` (test/reference oracle only)."""
    return jnp.linalg.inv(A.to_dense())
