"""Symmetric PSD matrix functions via eigendecomposition.

The reference computes covariance square roots with
``SelfAdjointEigenSolver::operatorSqrt`` (quadrature/SparseGaussHermite.h:231)
and the proximal step's matrix square root with a real Schur decomposition
(proxgd/ProxGVIFactorizedBaseGH.h:217-248).  Every matrix involved is
symmetric PSD (covariances, or similar to one), so a clamped ``eigh`` sqrt is
both simpler and SPD-safe — this is the "eigh-clamped sqrt" design note of
SURVEY.md section 7.
"""

from __future__ import annotations

import jax.numpy as jnp
from .precision import einsum


def psd_sqrtm(mat: jnp.ndarray, clamp: float = 0.0) -> jnp.ndarray:
    """Symmetric square root of a symmetric PSD matrix (batched ok)."""
    w, v = jnp.linalg.eigh(mat)
    w = jnp.maximum(w, clamp)
    return einsum("...ij,...j,...kj->...ik", v, jnp.sqrt(w), v)


def psd_inv_sqrtm(mat: jnp.ndarray, eps: float = 1e-30) -> jnp.ndarray:
    w, v = jnp.linalg.eigh(mat)
    w = jnp.maximum(w, eps)
    return einsum("...ij,...j,...kj->...ik", v, 1.0 / jnp.sqrt(w), v)


# Scaled Denman-Beavers sweep count (see sqrtm_product): determinant
# scaling gives near-shape-independent convergence.  Measured vs the f64
# eigh oracle: max-rel 2e-15 at kappa(A)=1, 1.3e-13 at 1e4, 1.9e-8 at
# 1e8 — the last is NOT iteration truncation (9 and 11 sweeps agree) but
# the conditioning floor of working on B = A(A+4sI) directly
# (kappa(B) ~ kappa(A)^2 ~ 1/eps_f64), and sits well below f32
# resolution ('auto' keeps eigh on the CPU, the f64 path).
_DB_ITERS = 11


def sqrtm_product(a: jnp.ndarray, s: float | jnp.ndarray,
                  method: str = "auto") -> jnp.ndarray:
    """sqrtm(A (A + 4 s I)) for symmetric PSD ``A`` — the JKO-step root.

    A and A + 4sI commute, so the root is ``V sqrt(w (w + 4 s)) V^T`` in A's
    eigenbasis; replaces the reference's general Schur sqrtm of the product
    (proxgd/ProxGVIFactorizedBaseGH.h:95-99, 217-248).

    ``method='eigh'`` is that eigenbasis form.  ``method='newton'`` is a
    determinant-scaled Denman-Beavers iteration instead: X -> sqrt(B),
    Y -> sqrt(B)^-1 for B = A(A+4sI), each sweep two loop-free small-matrix
    Cholesky inversions + two log-dets (ops/smallmat) — elementwise work
    that fuses, with no eigensolver call.  ``'auto'`` resolves per
    platform (:func:`..resolve.sqrtm_method`).  A trace-scaled jitter
    floors exactly-singular B (the eigh path clamps the same eigenvalues
    at zero).
    """
    if method == "auto":
        from .. import resolve

        method = resolve.sqrtm_method(resolve.target_platform(), method)
    if method == "eigh":
        w, v = jnp.linalg.eigh(a)
        vals = jnp.sqrt(jnp.maximum(w * (w + 4.0 * s), 0.0))
        return einsum("...ij,...j,...kj->...ik", v, vals, v)

    from .smallmat import logdet_spd_small, spd_inv_small

    d = a.shape[-1]
    eye = jnp.eye(d, dtype=a.dtype)
    b = einsum("...ij,...jk->...ik", a, a) + (4.0 * s) * a
    b = 0.5 * (b + jnp.swapaxes(b, -1, -2))
    tr = jnp.trace(b, axis1=-2, axis2=-1)[..., None, None]
    fi = jnp.finfo(a.dtype)
    x = b + (fi.eps * tr / d + fi.tiny) * eye
    y = jnp.broadcast_to(eye, x.shape)
    for _ in range(_DB_ITERS):
        # mu = |det X det Y|^(-1/(2d)) rescales both iterates onto the
        # unit-determinant orbit, where DB contracts quadratically
        # regardless of the initial spread (Higham's scaled DB)
        ld = logdet_spd_small(x) + logdet_spd_small(y)
        mu = jnp.exp(-ld / (2.0 * d))[..., None, None]
        xi = spd_inv_small(x)
        yi = spd_inv_small(y)
        x, y = 0.5 * (mu * x + yi / mu), 0.5 * (mu * y + xi / mu)
    return 0.5 * (x + jnp.swapaxes(x, -1, -2))
