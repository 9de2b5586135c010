"""Log-depth (associative-scan) block-tridiagonal chain algebra.

The sequential GBP sweeps and Thomas solves in :mod:`.blocktridiag` have
O(N) sequential depth — fine for short chains, but the chain length is this
workload's "sequence" axis (SURVEY.md section 5.7) and on an accelerator
the scans are latency-bound.  This module reformulates all three chain recurrences as
``jax.lax.associative_scan`` prefix computations with O(log N) depth:

1.  **Schur/GBP messages.**  The forward message recurrence
    ``m' = -B^T (D + m)^{-1} B`` lives in the family of matrix
    linear-fractional maps ``m -> Q - U^T (R + m)^{-1} U``.  This family is
    closed under composition (one Woodbury identity):

        (g o f):  S  = R_g + Q_f
                  Q' = Q_g - U_g^T S^{-1} U_g
                  R' = R_f - U_f S^{-1} U_f^T
                  U' = U_f S^{-1} U_g

    Composition is associative, so all prefix compositions — hence all
    forward pivots ``F_i = D_i + m_i`` — come from one associative scan;
    the backward pivots from the reversed scan.  This is the chain-Gaussian
    analog of temporally-parallel Kalman filtering (Sarkka &
    Garcia-Fernandez, 2021).

2.  **Log det** = sum log det F_i (the forward pivots ARE the block-Cholesky
    pivots).

3.  **Solve.**  Given the pivots, forward elimination and back substitution
    are affine recurrences ``y' = M y + c`` — associative under
    ``(M2, c2) o (M1, c1) = (M2 M1, M2 c1 + c2)``.

Everything here is numerically identical (up to fp reassociation) to the
sequential versions and validated against them in tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .blocktridiag import BlockTridiag, spd_inv, spd_solve
from .smallmat import logdet_spd_small
from .precision import einsum, matmul


def _compose_lft(a, b):
    """(b o a) for m -> Q - U^T (R + m)^{-1} U maps; a applied first."""
    q_a, r_a, u_a = a
    q_b, r_b, u_b = b
    s_inv_ub = spd_solve(r_b + q_a, u_b)             # S^{-1} U_b
    s_inv_uat = spd_solve(r_b + q_a, jnp.swapaxes(u_a, -1, -2))  # S^{-1} U_a^T
    q = q_b - matmul(jnp.swapaxes(u_b, -1, -2), s_inv_ub)
    r = r_a - matmul(u_a, s_inv_uat)
    u = matmul(u_a, s_inv_ub)
    return (q, r, u)


def forward_pivots(A: BlockTridiag) -> jnp.ndarray:
    """All forward Schur pivots F_i = D_i + m_i, [N, s, s], in O(log N) depth.

    F_0 = D_0;  F_i = D_i - B_{i-1}^T F_{i-1}^{-1} B_{i-1}.
    """
    n, s = A.num_states, A.block_dim
    if n == 1:
        return A.diag
    elems = (
        jnp.zeros((n - 1, s, s), A.diag.dtype),  # Q
        A.diag[:-1],                             # R
        A.off,                                   # U
    )
    q_c, r_c, u_c = lax.associative_scan(_compose_lft, elems)
    # prefix map evaluated at m_0 = 0: m_{i+1} = Q_i - U_i^T R_i^{-1} U_i
    msgs = q_c - matmul(jnp.swapaxes(u_c, -1, -2), spd_solve(r_c, u_c))
    return jnp.concatenate([A.diag[:1], A.diag[1:] + msgs], axis=0)


def backward_pivots(A: BlockTridiag) -> jnp.ndarray:
    """All backward pivots G_i = D_i + b_i, [N, s, s]:
    G_{n-1} = D_{n-1};  G_i = D_i - B_i G_{i+1}^{-1} B_i^T."""
    n, s = A.num_states, A.block_dim
    if n == 1:
        return A.diag
    elems = (
        jnp.zeros((n - 1, s, s), A.diag.dtype),
        A.diag[1:],
        jnp.swapaxes(A.off, -1, -2),
    )
    rev = tuple(e[::-1] for e in elems)
    q_c, r_c, u_c = lax.associative_scan(_compose_lft, rev)
    msgs_rev = q_c - matmul(jnp.swapaxes(u_c, -1, -2), spd_solve(r_c, u_c))
    msgs = msgs_rev[::-1]
    return jnp.concatenate([A.diag[:-1] + msgs, A.diag[-1:]], axis=0)


def gbp_covariance_logdet_assoc(
    A: BlockTridiag,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Covariance blocks + log det with O(log N) sequential depth.

    Same outputs as blocktridiag.gbp_covariance_logdet.
    """
    n, s = A.num_states, A.block_dim
    if n == 1:
        ld = logdet_spd_small(A.diag[0])
        return spd_inv(A.diag[0])[None], A.off, ld

    f_piv = forward_pivots(A)
    g_piv = backward_pivots(A)

    ld = jnp.sum(logdet_spd_small(f_piv))

    joint = jnp.concatenate(
        [
            jnp.concatenate([f_piv[:-1], A.off], axis=2),
            jnp.concatenate(
                [jnp.swapaxes(A.off, -1, -2), g_piv[1:]], axis=2
            ),
        ],
        axis=1,
    )
    joint_cov = spd_inv(joint)
    cov_diag = jnp.concatenate(
        [joint_cov[:, :s, :s], joint_cov[-1:, s:, s:]], axis=0
    )
    cov_off = joint_cov[:, :s, s:]
    return cov_diag, cov_off, ld


def _compose_affine(a, b):
    """(b o a) for affine maps y -> M y + c; a applied first."""
    m_a, c_a = a
    m_b, c_b = b
    return (matmul(m_b, m_a), einsum("...ij,...j->...i", m_b, c_a) + c_b)


def solve_assoc(A: BlockTridiag, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b in O(log N) depth using associative-scan pivots and
    affine-recurrence elimination/substitution."""
    n, s = A.num_states, A.block_dim
    bb = b.reshape(n, s)
    f_piv = forward_pivots(A)
    if n == 1:
        return spd_solve(f_piv[0], bb[0]).reshape(b.shape)

    # forward elimination: y_0 = b_0; y_i = b_i - B_{i-1}^T F_{i-1}^{-1} y_{i-1}
    m_fwd = -matmul(jnp.swapaxes(A.off, -1, -2), spd_inv(f_piv[:-1]))  # [n-1,s,s]
    m_c, c_c = lax.associative_scan(_compose_affine, (m_fwd, bb[1:]))
    ys = jnp.concatenate(
        [bb[:1], einsum("nij,j->ni", m_c, bb[0]) + c_c], axis=0
    )

    # back substitution: x_{n-1} = F_{n-1}^{-1} y_{n-1};
    # x_i = F_i^{-1} (y_i - B_i x_{i+1})
    f_inv_y = spd_solve(f_piv, ys[:, :, None])[:, :, 0]
    m_bwd = -matmul(spd_inv(f_piv[:-1]), A.off)                        # [n-1,s,s]
    rev = (m_bwd[::-1], f_inv_y[:-1][::-1])
    m_c2, c_c2 = lax.associative_scan(_compose_affine, rev)
    x_last = f_inv_y[-1]
    xs_rev = einsum("nij,j->ni", m_c2, x_last) + c_c2
    xs = jnp.concatenate([xs_rev[::-1], x_last[None]], axis=0)
    return xs.reshape(b.shape)


def logdet_assoc(A: BlockTridiag) -> jnp.ndarray:
    return jnp.sum(logdet_spd_small(forward_pivots(A)))
