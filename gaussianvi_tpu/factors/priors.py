"""GP prior factor builders (the reference's gp/ model library).

All builders emit :class:`LinearFactorBatch` rows — closed-form linear
Gaussian factors ``psi(x) = C ||Lam x - Psi mu_t||^2_{prec_t}`` — batched
over all trajectory segments at once.

* fixed prior: anchor at a state (gp/fixed_prior.h:19-50)
* minimum-acceleration (constant-velocity) GP: closed-form Phi/Q
  (gp/minimum_acc_prior.h:26-130)
* LTV-system GP: Phi and controllability Gramian by ODE integration
  (gp/LTV_prior.h:28-247, which uses GSL rkf45; here a fixed-step RK4
  matrix integrator in NumPy — offline model building, not a hot path)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .base import LinearFactorBatch, detect_slice_offset
from ..ops.precision import matmul


def _as_batch(start, lam, psi, target_mu, target_prec, constant, nb, dtype):
    start_np = np.asarray(start, np.int32)
    return LinearFactorBatch(
        start=jnp.asarray(start_np),
        lam=jnp.asarray(lam, dtype),
        psi=jnp.asarray(psi, dtype),
        target_mu=jnp.asarray(target_mu, dtype),
        target_prec=jnp.asarray(target_prec, dtype),
        constant=jnp.asarray(constant, dtype),
        nb=nb,
        slice_offset=detect_slice_offset(start_np),
    )


def fixed_prior(
    state_index: int, mu0, covariance, dtype=None
) -> LinearFactorBatch:
    """Anchor prior psi(x) = ||x - mu0||^2_{K^{-1}} at one state.

    Lam = Psi = I, C = 1 (gp/fixed_prior.h:19-50).
    """
    mu0 = np.asarray(mu0, np.float64)
    cov = np.asarray(covariance, np.float64)
    s = mu0.shape[0]
    dtype = dtype or jnp.zeros(0).dtype
    return _as_batch(
        [state_index],
        np.eye(s)[None],
        np.eye(s)[None],
        mu0[None],
        np.linalg.inv(cov)[None],
        [1.0],
        nb=1,
        dtype=dtype,
    )


def min_acc_q(qc: np.ndarray, dt: float) -> np.ndarray:
    """Closed-form constant-velocity process noise
    Q = [[dt^3/3 Qc, dt^2/2 Qc], [dt^2/2 Qc, dt Qc]]
    (gp/minimum_acc_prior.h:52-68)."""
    d = qc.shape[0]
    q = np.zeros((2 * d, 2 * d))
    q[:d, :d] = qc * dt**3 / 3.0
    q[:d, d:] = qc * dt**2 / 2.0
    q[d:, :d] = qc * dt**2 / 2.0
    q[d:, d:] = qc * dt
    return q


def min_acc_q_inv(qc_inv: np.ndarray, dt: float) -> np.ndarray:
    """Closed-form Q^{-1} (gp/minimum_acc_prior.h:110-116)."""
    d = qc_inv.shape[0]
    qi = np.zeros((2 * d, 2 * d))
    qi[:d, :d] = 12.0 * qc_inv / dt**3
    qi[:d, d:] = -6.0 * qc_inv / dt**2
    qi[d:, :d] = -6.0 * qc_inv / dt**2
    qi[d:, d:] = 4.0 * qc_inv / dt
    return qi


def minimum_acc_prior(
    qc, delta_t: float, num_states: int, dtype=None
) -> LinearFactorBatch:
    """Constant-velocity GP prior between every consecutive state pair.

    State is [x; v] (dim s = 2 dim(x)); Phi = [[I, dt I], [0, I]];
    Lam = [-Phi, I] over the pair, Psi = 0, C = 1/2
    (gp/minimum_acc_prior.h:26-130: the Psi mean-drift term is disabled
    upstream because a(t) = 0).
    """
    qc = np.atleast_2d(np.asarray(qc, np.float64))
    d = qc.shape[0]
    s = 2 * d
    dtype = dtype or jnp.zeros(0).dtype
    k = num_states - 1
    phi = np.eye(s)
    phi[:d, d:] = delta_t * np.eye(d)
    lam = np.zeros((s, 2 * s))
    lam[:, :s] = -phi
    lam[:, s:] = np.eye(s)
    qinv = min_acc_q_inv(np.linalg.inv(qc), delta_t)
    return _as_batch(
        np.arange(k),
        np.broadcast_to(lam, (k, s, 2 * s)),
        np.zeros((k, s, 2 * s)),
        np.zeros((k, 2 * s)),
        np.broadcast_to(qinv, (k, s, s)),
        np.full(k, 0.5),
        nb=2,
        dtype=dtype,
    )


def minimum_acc_prior_integral(
    qc, delta_t: float, num_states: int, nsteps: int = 200, dtype=None
) -> LinearFactorBatch:
    """Numerically-integrated variant of the constant-velocity prior.

    The reference ships ``MinimumAccGP_integral`` (Euler-integrated Phi,
    gp/minimum_acc_prior_integral.h) purely to cross-validate the LTV ODE
    machinery against the closed forms; here the same check uses the RK4
    integrator of :func:`ltv_transition_and_gramian` with
    A = [[0, I], [0, 0]], B = [[0], [chol(Qc)]].
    """
    qc = np.atleast_2d(np.asarray(qc, np.float64))
    d = qc.shape[0]
    s = 2 * d
    dtype = dtype or jnp.zeros(0).dtype
    a = np.zeros((s, s))
    a[:d, d:] = np.eye(d)
    b = np.zeros((s, d))
    b[d:, :] = np.linalg.cholesky(qc)
    phi, q = ltv_transition_and_gramian(
        np.broadcast_to(a, (5, s, s)), np.broadcast_to(b, (5, s, d)),
        delta_t, nsteps,
    )
    k = num_states - 1
    lam = np.zeros((s, 2 * s))
    lam[:, :s] = -phi
    lam[:, s:] = np.eye(s)
    return _as_batch(
        np.arange(k),
        np.broadcast_to(lam, (k, s, 2 * s)),
        np.zeros((k, 2 * s, 2 * s))[:, :s, :],
        np.zeros((k, 2 * s)),
        np.broadcast_to(np.linalg.inv(q), (k, s, s)),
        np.full(k, 0.5),
        nb=2,
        dtype=dtype,
    )


# ---------------------------------------------------------------------------
# LTV-system GP prior
# ---------------------------------------------------------------------------

def _rk4_matrix(rhs, y0: np.ndarray, t0: float, t1: float, nsteps: int):
    """Classical fixed-step RK4 for matrix ODEs (replaces GSL rkf45 at
    tol 1e-12, gp/LTV_prior.h:123-152; with 200 steps over one segment the
    piecewise-constant-coefficient solution is exact to ~1e-13)."""
    h = (t1 - t0) / nsteps
    y, t = y0, t0
    for _ in range(nsteps):
        k1 = rhs(t, y)
        k2 = rhs(t + h / 2, y + h / 2 * k1)
        k3 = rhs(t + h / 2, y + h / 2 * k2)
        k4 = rhs(t + h, y + h * k3)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        t += h
    return y


def ltv_transition_and_gramian(
    a_seg: np.ndarray, b_seg: np.ndarray, delta_t: float, nsteps: int = 200
) -> tuple[np.ndarray, np.ndarray]:
    """Phi(dt, 0) and controllability Gramian Q for one segment.

    ``a_seg [P, s, s]`` / ``b_seg [P, s, m]`` are piecewise-constant system
    matrices over P - 1 equal sub-intervals of the segment (the reference
    uses P = 5 with lookup floor(4 t / dt), gp/LTV_prior.h:54-59, 187-197 —
    slot 4 is active only at the measure-zero endpoint t = dt and does not
    enter the converged solution).  CONVENTION for P != 5: the lookup
    factor is derived as P - 1 (sub-interval j covers
    ``[j dt/(P-1), (j+1) dt/(P-1))``, generalizing the reference's
    hard-coded 4); callers providing a different P must supply matrices on
    exactly that uniform grid — the last slot is never integrated over.

        Phi' = A(t) Phi,  Phi(0) = I
        Q'   = A Q + Q A^T + B B^T,  Q(0) = 0

    Integrated PIECE BY PIECE: each sub-interval runs fixed-step RK4 with
    its own constant (A_j, B_j), so no RK4 stage ever samples across a
    coefficient discontinuity.  (A single RK4 sweep with an in-stage
    floor(4 t / dt) lookup — the previous implementation — has O(h)
    boundary-stage errors: ~1e-3 at nsteps = 200 on strongly time-varying
    systems, measured against a DOP853 1e-13 oracle in
    tests/test_ltv_oracle.py.  The piecewise sweep converges at clean 4th
    order to the same limit the reference's adaptive rkf45-at-1e-12
    reaches.)  ``nsteps`` is the total step count across the segment.
    """
    p = a_seg.shape[0]
    s = a_seg.shape[1]
    pieces = max(p - 1, 1)
    h_piece = delta_t / pieces
    # distribute nsteps over the pieces so the TOTAL equals the request
    # (floor-per-piece alone would quantize it to a multiple of `pieces`,
    # silently coarsening non-multiple step counts)
    base, extra = divmod(max(nsteps, pieces), pieces)

    phi = np.eye(s)
    q = np.zeros((s, s))
    for j in range(pieces):
        per = base + (1 if j < extra else 0)
        a, b = a_seg[j], b_seg[j]
        bbt = matmul(b, b.T)
        phi = _rk4_matrix(
            lambda t, y, a=a: matmul(a, y), phi, 0.0, h_piece, per
        )
        q = _rk4_matrix(
            lambda t, y, a=a, bbt=bbt: matmul(a, y) + matmul(y, a.T) + bbt,
            q, 0.0, h_piece, per,
        )
    return phi, q


def ltv_prior(
    a_list,
    b_list,
    target_means,
    delta_t: float,
    num_states: int,
    dtype=None,
    nsteps: int = 200,
) -> LinearFactorBatch:
    """LTV GP prior over every consecutive state pair.

    ``a_list``/``b_list`` index piecewise-constant (A, B) with 4*i + j for
    segment i, sub-interval j (5 per segment, reference gp/LTV_prior.h:46-52);
    ``target_means`` is the list of nominal means per state.  Lam = [-Phi, I],
    Psi = [Phi, -I] (active for LTV, gp/LTV_prior.h:92-94), C = 1/2,
    prec_t = Q^{-1}.
    """
    s = np.asarray(a_list[0]).shape[0]
    k = num_states - 1
    dtype = dtype or jnp.zeros(0).dtype
    lam = np.zeros((k, s, 2 * s))
    psi = np.zeros((k, s, 2 * s))
    prec = np.zeros((k, s, s))
    tmu = np.zeros((k, 2 * s))
    for i in range(k):
        a_seg = np.stack([np.asarray(a_list[4 * i + j]) for j in range(5)])
        b_seg = np.stack([np.asarray(b_list[4 * i + j]) for j in range(5)])
        phi, q = ltv_transition_and_gramian(a_seg, b_seg, delta_t, nsteps)
        lam[i, :, :s] = -phi
        lam[i, :, s:] = np.eye(s)
        psi[i, :, :s] = phi
        psi[i, :, s:] = -np.eye(s)
        prec[i] = np.linalg.inv(q)
        tmu[i, :s] = np.asarray(target_means[i])
        tmu[i, s:] = np.asarray(target_means[i + 1])
    return _as_batch(
        np.arange(k), lam, psi, tmu, prec, np.full(k, 0.5), nb=2, dtype=dtype
    )
