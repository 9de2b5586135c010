"""Fused sigma-point moment computation and per-factor gradient math.

The hot loop of the whole framework.  For a batch of K factors with marginals
``(mu [K,d], cov [K,d,d])`` and an M-point rule, computes in ONE pass over
the sigma points:

    E[phi], E[(x-mu) phi], E[(x-mu)(x-mu)^T phi]

The reference evaluates the cost function three times — once per moment —
in three separate ``Integrate`` calls (ngd/NGDFactorizedBaseGH.h:53-74 calls
quadrature/SparseGaussHermite.h:197-221 thrice); here ``phi`` is evaluated
once and the three weighted reductions are einsums that XLA fuses.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..ops.blocktridiag import spd_inv
from ..ops.psd import psd_sqrtm
from ..ops.smallmat import chol_small
from ..ops.precision import einsum


def sigma_points(
    nodes: jnp.ndarray, mu: jnp.ndarray, cov: jnp.ndarray,
    method: str = "cholesky",
) -> jnp.ndarray:
    """Place zero-mean nodes at N(mu_k, cov_k): ``nodes @ L.T + mu`` for any
    factor L with L L^T = P.

    ``method='cholesky'`` (default) matches the reference's full-GH
    placement (quadrature/GaussHermite-impl.h:100, LLT) and is cheaper than
    eigh; ``method='eigh'`` matches the sparse-GH placement
    (quadrature/SparseGaussHermite.h:231-243, operatorSqrt).  For symmetric
    rules both give identical results on polynomials up to the rule's
    exactness order; estimates differ only within quadrature error.
    Shapes: nodes [M,d], mu [K,d], cov [K,d,d] -> [K,M,d].
    """
    if method == "cholesky":
        sqrt_p = chol_small(cov)  # unrolled for small d; loop-free
    else:
        sqrt_p = psd_sqrtm(cov)  # symmetric
    # x = L xi per point: out[k,m,:] = L_k @ nodes[m]  (nodes @ L^T)
    return einsum("md,ked->kme", nodes, sqrt_p) + mu[:, None, :]


def eval_phi(
    cost_fn: Callable[..., jnp.ndarray], pts: jnp.ndarray, params: Any
) -> jnp.ndarray:
    """phi over the sigma batch: pts [K,M,d] -> [K,M]."""
    per_factor = jax.vmap(cost_fn, in_axes=(0, None))  # over M points
    if params is None:
        return jax.vmap(lambda p: per_factor(p, None))(pts)
    return jax.vmap(per_factor, in_axes=(0, 0))(pts, params)


def batch_phi(fb, mu_k, cov_k, eval_dtype=None):
    """E[phi] for a NonlinearFactorBatch (the line-search cost path; see
    :func:`expectation_phi`), with the batch's nonneg contract."""
    return expectation_phi(
        fb.nodes, fb.weights, mu_k, cov_k, fb.cost_fn, fb.params, eval_dtype,
        nonneg=fb.nonneg_cost,
    )


def batch_moments(fb, mu_k, cov_k, eval_dtype=None):
    """Moments for a NonlinearFactorBatch (see :func:`gh_moments`)."""
    return gh_moments(
        fb.nodes, fb.weights, mu_k, cov_k, fb.cost_fn, fb.params, eval_dtype,
        rdim=fb.quad_rdim,
    )


def _sigma_diffs(nodes, cov, eval_dtype=None):
    """Zero-mean sigma offsets ``nodes @ L^T`` [K, M, d], optionally
    QUANTIZED to ``eval_dtype`` (round-tripped back to the working dtype).

    Centered quantization is the bf16 mode that survives residual-style
    costs: rounding the OFFSET from the marginal mean keeps the error
    relative to the (small) offset, whereas rounding the absolute sigma
    point x = mu + offset loses the offset entirely once |mu| >> |offset|
    (the round-1 study measured up to 10% E[phi] error from exactly that
    catastrophic cancellation).  phi itself is always evaluated in the
    working precision; the quantization only compresses the [K, M, d]
    sigma-offset tensor — the largest intermediate of the hot loop.
    """
    sqrt_p = chol_small(cov)
    diff = einsum("md,ked->kme", nodes, sqrt_p)
    if eval_dtype is not None:
        diff = diff.astype(eval_dtype).astype(cov.dtype)
    return diff


def gh_moments(
    nodes: jnp.ndarray,
    weights: jnp.ndarray,
    mu: jnp.ndarray,
    cov: jnp.ndarray,
    cost_fn: Callable[..., jnp.ndarray],
    params: Any,
    eval_dtype=None,
    rdim: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused (E[phi] [K], E[(x-mu)phi] [K,d], E[(x-mu)(x-mu)^T phi] [K,d,d]).

    ``eval_dtype`` (e.g. ``jnp.bfloat16``): centered sigma-offset
    quantization (see :func:`_sigma_diffs`); the weighted reductions always
    accumulate in the input dtype (sparse-grid weights are signed).

    ``rdim`` (NonlinearFactorBatch.quad_rdim): MARGINAL quadrature — phi
    depends only on the first r dims of x and ``nodes`` carry an r-dim rule
    zero-padded to d.  With lower-triangular Cholesky placement
    (L = [[L11, 0], [L21, L22]], x = mu + L xi) the padded nodes hit the
    position-marginal sigma points exactly, and the EXACT Gaussian
    conditional-moment lift collapses onto the standard assembly:

        E[(x-mu) phi]          = C Spp^-1 E_p[(p-mu_p) phi]
                               = L sum_m w_m xi~_m phi_m        (as-is)
        E[(x-mu)(x-mu)^T phi]  = L (sum_m w_m xi~ xi~^T phi) L^T
                                 + (Sigma - C Spp^-1 C^T) E[phi]

    with C = Sigma P^T, Spp = P Sigma P^T, and Sigma - C Spp^-1 C^T =
    L[:, r:] L[:, r:]^T (a cancellation-free sum of products, nonzero only
    in the trailing velocity block) — only the last line's correction term
    is not produced by the standard assembly, and it is added here in
    closed form (no extra quadrature).  Derivation: E[x-mu | p] =
    C Spp^-1 (p-mu_p) and E[(x-mu)(x-mu)^T | p] = Sigma - C Spp^-1 C^T +
    (C Spp^-1 (p-mu_p))(.)^T.
    """
    sqrt_p = chol_small(cov)                      # [K,d,d] lower
    diff = einsum("md,ked->kme", nodes, sqrt_p)   # [K,M,d]
    if eval_dtype is not None:
        diff = diff.astype(eval_dtype).astype(cov.dtype)
    pts = diff + mu[:, None, :]
    phi = eval_phi(cost_fn, pts, params)          # [K,M]
    wphi = phi * weights[None, :]                 # [K,M]
    e_phi = jnp.sum(wphi, axis=-1)
    e_xmu = einsum("km,kmd->kd", wphi, diff)
    e_xxt = einsum("km,kmd,kme->kde", wphi, diff, diff)
    if rdim is not None and rdim < mu.shape[-1]:
        lhi = sqrt_p[..., rdim:]                  # L[:, r:]  [K,d,d-r]
        corr = einsum("kat,kbt->kab", lhi, lhi)
        e_xxt = e_xxt + corr * e_phi[:, None, None]
    return e_phi, e_xmu, e_xxt


# Rounding-band width (in ulps of sum |w phi|) for the nonneg-phi guard:
# negative estimates of a nonnegative integrand inside the band are f32
# summation garbage (poisoned); outside it they are genuine quadrature
# error an f64 evaluation reproduces (kept).  The f32 accept-collapse class
# measured |sum|/sum|w phi| <= ~2e-5 (~170 ulps); the smallest LEGITIMATE
# negative observed (arm planner) sits at 3.2e-3 (~2.7e4 ulps) — 4096
# splits the gap with ~6x margin on either side.
_NONNEG_BAND = 4096.0


def expectation_phi(
    nodes: jnp.ndarray,
    weights: jnp.ndarray,
    mu: jnp.ndarray,
    cov: jnp.ndarray,
    cost_fn: Callable[..., jnp.ndarray],
    params: Any,
    eval_dtype=None,
    nonneg: bool = False,
) -> jnp.ndarray:
    """E[phi] only (the line-search cost path needs no moments).

    Cancellation-trust guarded: sparse-GH weights are signed
    (quadrature/SparseGaussHermite.h:197-221), and a huge-spread marginal
    can cancel the sum below the working precision's resolution — the f32
    residue then carries an arbitrary (often hugely negative) value that
    the line search would accept where f64 rejects (PERF.md sections
    14/27).  When |sum w phi| falls under ~64 ulps of sum |w phi| the
    estimate is poisoned to NaN, rejecting the trial (the same philosophy
    as the chain pivot-trust guard, ops/blocktridiag._guarded_logdet).

    ``nonneg`` (NonlinearFactorBatch.nonneg_cost): the integrand is known
    >= 0, so a negative estimate within the working precision's
    ROUNDING-noise band (|sum| < ~4096 ulps of sum |w phi|) is pure
    sign-garbage and is poisoned too — the residual 7/1024 device
    collapses sat exactly there, above the 64-ulp threshold (PERF.md
    round-5 section).  Negative estimates OUTSIDE the band are genuine
    QUADRATURE error of the signed-weight sparse rule on a kinked
    integrand — an f64 evaluation (and the reference) computes and uses
    the same value, so they pass through (e.g. the arm planner's 7-D
    deg-3 rule reads E[hinge] = -0.058 at 2.7e4 ulps on its initial
    trajectory; poisoning that froze the whole run)."""
    diff = _sigma_diffs(nodes, cov, eval_dtype)
    phi = eval_phi(cost_fn, diff + mu[:, None, :], params)
    wphi = phi * weights[None, :]
    tot = jnp.sum(wphi, axis=-1)
    absum = jnp.sum(jnp.abs(wphi), axis=-1)
    eps = float(jnp.finfo(tot.dtype).eps)
    bad = jnp.abs(tot) < 64.0 * eps * absum
    if nonneg:
        bad = bad | ((tot < 0.0) & (tot > -_NONNEG_BAND * eps * absum))
    return jnp.where(bad, jnp.nan, tot)


def ngd_local_gradients(
    e_phi: jnp.ndarray,
    e_xmu: jnp.ndarray,
    e_xxt: jnp.ndarray,
    cov: jnp.ndarray,
    temperature,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-factor natural-gradient pieces (reference NGDFactorizedBaseGH.h:53-74):

        Vdmu_k  = Prec_k E[(x-mu)phi] / T
        Vddmu_k = (Prec_k E[(x-mu)(x-mu)^T phi] Prec_k - Prec_k E[phi]) / T
    """
    prec = spd_inv(cov)                                        # [K,d,d]
    vdmu = einsum("kde,ke->kd", prec, e_xmu) / temperature
    vddmu = (
        einsum("kab,kbc,kcd->kad", prec, e_xxt, prec)
        - prec * e_phi[:, None, None]
    ) / temperature
    vddmu = 0.5 * (vddmu + jnp.swapaxes(vddmu, -1, -2))
    return vdmu, vddmu


def bw_local_gradients(
    e_phi: jnp.ndarray,
    e_xmu: jnp.ndarray,
    e_xxt: jnp.ndarray,
    cov: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Bures-Wasserstein gradients (proxgd/ProxGVIFactorizedBaseGH.h:153-161):

        b_k = Prec_k E[(x-mu)phi]
        S_k = Prec_k E[(x-mu)(x-mu)^T phi] Prec_k - Prec_k E[phi]
    """
    prec = spd_inv(cov)
    b_k = einsum("kde,ke->kd", prec, e_xmu)
    s_k = (
        einsum("kab,kbc,kcd->kad", prec, e_xxt, prec)
        - prec * e_phi[:, None, None]
    )
    s_k = 0.5 * (s_k + jnp.swapaxes(s_k, -1, -2))
    return b_k, s_k


def linear_local_gradients(
    lam: jnp.ndarray,
    psi: jnp.ndarray,
    target_mu: jnp.ndarray,
    target_prec: jnp.ndarray,
    constant: jnp.ndarray,
    mu: jnp.ndarray,
    temperature,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form NGD gradients for linear-Gaussian factors.

    Vdmu follows ngd/NGDFactorizedLinear.h:104-106.  The reference's O(d^4)
    Isserlis quadruple loop (ibid.:108-119) collapses algebraically: with
    A = Lam^T prec_t Lam and Prec = Cov^{-1},

        Prec (Cov tr(A Cov) + 2 Cov A Cov) Prec - Prec tr(A Cov) = 2 A,

    so Vddmu = 2 A C / T exactly — no moments, no covariance dependence.
    (Verified against the loop in tests/test_linear_factors.py.)
    """
    resid = einsum("krd,kd->kr", lam, mu) - einsum(
        "krt,kt->kr", psi, target_mu
    )
    vdmu = (
        2.0
        * einsum("krd,krs,ks->kd", lam, target_prec, resid)
        * constant[:, None]
        / temperature
    )
    a = einsum("kra,krs,ksb->kab", lam, target_prec, lam)
    vddmu = 2.0 * a * constant[:, None, None] / temperature
    return vdmu, vddmu


def _guard_linear_cost(cost: jnp.ndarray) -> jnp.ndarray:
    """Nonneg contract for CLOSED-FORM linear factor costs: tr(A Sigma) +
    ||resid||^2_P is >= 0 in exact arithmetic for ANY SPD Sigma (A PSD),
    so — unlike the quadrature estimates, which have a legitimate
    negative-error regime — a negative value here is always f32 garbage.
    The round-5 device probe (scripts/r5_collapse_probe.py) pinned ALL 7
    residual PERF-section-27 collapses to exactly this term: on
    huge-spread trial iterates the signed elementwise sums of tr(A Sigma)
    cancel catastrophically (f32 totals of -4.8e3/-1.4e5 against f64
    +2.6e4/+7.0e4) while the nonlinear quadrature sums stay healthy
    (min |sum|/sum|w phi| ~ 0.04).  Poisoning to NaN rejects the trial —
    the f64-reject behavior at f32 speed (same philosophy as the chain
    pivot-trust and quadrature cancellation guards)."""
    return jnp.where(cost < 0, jnp.nan, cost)


def batch_linear_cost(lb, mu, cov_diag, cov_off):
    """E[psi] for a LinearFactorBatch from the chain blocks.

    nb == 2 edge factors use the blockwise form (:func:`linear_cost_chain`)
    — same value as assembling the [K, 2s, 2s] edge marginal, without
    materializing it.
    """
    from ..inference.graph import gather_chain_edges, gather_marginals

    if lb.nb == 2:
        return linear_cost_chain(
            lb.lam, lb.psi, lb.target_mu, lb.target_prec, lb.constant,
            *gather_chain_edges(
                lb.start, mu, cov_diag, cov_off, lb.slice_offset
            ),
        )
    mu_k, cov_k = gather_marginals(
        lb.start, lb.nb, mu, cov_diag, cov_off, lb.slice_offset
    )
    return linear_cost(
        lb.lam, lb.psi, lb.target_mu, lb.target_prec, lb.constant,
        mu_k, cov_k,
    )


def linear_cost_chain(
    lam: jnp.ndarray,
    psi: jnp.ndarray,
    target_mu: jnp.ndarray,
    target_prec: jnp.ndarray,
    constant: jnp.ndarray,
    mu_i: jnp.ndarray,
    mu_ip1: jnp.ndarray,
    cd_i: jnp.ndarray,
    cd_ip1: jnp.ndarray,
    co_i: jnp.ndarray,
) -> jnp.ndarray:
    """Closed-form E[psi] for nb==2 (edge) linear factors computed from the
    chain blocks directly — same value as :func:`linear_cost` on the
    assembled edge marginal, WITHOUT materializing the [K, 2s, 2s]
    edge-covariance tensor (at the line-search trial batch that tensor plus
    the gathers behind it are pure HBM traffic).  With A = Lam^T prec_t Lam
    partitioned into s x s blocks and Sigma_e symmetric:

        tr(A Sigma_e) = sum(A11 . Sig_ii) + sum(A22 . Sig_i+1,i+1)
                        + 2 sum(A12 . Sig_i,i+1)
    """
    s = cd_i.shape[-1]
    a = einsum("kra,krs,ksb->kab", lam, target_prec, lam)
    # the 2*sum(A12 . Sig_i,i+1) folding below needs A symmetric; with Sig
    # symmetric tr(A Sig) = tr(sym(A) Sig), so symmetrizing keeps this path
    # equal to linear_cost even for an asymmetric target_prec
    a = 0.5 * (a + jnp.swapaxes(a, -1, -2))
    tr_term = (
        jnp.sum(a[:, :s, :s] * cd_i, axis=(-2, -1))
        + jnp.sum(a[:, s:, s:] * cd_ip1, axis=(-2, -1))
        + 2.0 * jnp.sum(a[:, :s, s:] * co_i, axis=(-2, -1))
    )
    mu_k = jnp.concatenate([mu_i, mu_ip1], axis=-1)
    resid = einsum("krd,kd->kr", lam, mu_k) - einsum(
        "krt,kt->kr", psi, target_mu
    )
    quad = einsum("kr,krs,ks->k", resid, target_prec, resid)
    return _guard_linear_cost((tr_term + quad) * constant)


def linear_cost(
    lam: jnp.ndarray,
    psi: jnp.ndarray,
    target_mu: jnp.ndarray,
    target_prec: jnp.ndarray,
    constant: jnp.ndarray,
    mu: jnp.ndarray,
    cov: jnp.ndarray,
) -> jnp.ndarray:
    """Closed-form E[psi] (ngd/NGDFactorizedLinear.h:122-129):

        (tr(Lam^T prec_t Lam Cov) + ||Lam mu - Psi mu_t||^2_{prec_t}) * C
    """
    a = einsum("kra,krs,ksb->kab", lam, target_prec, lam)
    tr_term = jnp.trace(einsum("kab,kbc->kac", a, cov), axis1=-2, axis2=-1)
    resid = einsum("krd,kd->kr", lam, mu) - einsum(
        "krt,kt->kr", psi, target_mu
    )
    quad = einsum("kr,krs,ks->k", resid, target_prec, resid)
    return _guard_linear_cost((tr_term + quad) * constant)
