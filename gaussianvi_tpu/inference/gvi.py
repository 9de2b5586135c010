"""Joint-level cost and gradient assembly shared by the NGD and Prox paths.

Mirrors the math of gvibase/GVI-GH-impl.h (cost = sum_k E[psi_k] + 0.5 log
det Lambda), ngd/NGD-GH-impl.h (joint natural-gradient assembly) and
proxgd/ProxGVI-GH-impl.h (summed per-factor JKO pseudo-gradients) — but as
pure jittable functions over batched factor groups, with the chain covariance
coming from the scan-based GBP engine instead of sparse selected inversion.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..factors import moments as mm
from ..ops.blocktridiag import BlockTridiag, gbp_covariance, spd_inv
from ..ops.parallel_chain import gbp_covariance_logdet_assoc
from ..ops.psd import sqrtm_product
from .graph import FactorGraph, gather_marginals, scatter_gradients
from ..ops.precision import einsum


def factor_costs(
    graph: FactorGraph,
    mu: jnp.ndarray,
    cov_diag: jnp.ndarray,
    cov_off: jnp.ndarray,
    temperature,
    temper_costs: bool = True,
    eval_dtype=None,
) -> jnp.ndarray:
    """Concatenated per-factor expected costs E[psi_k] (optionally / T).

    NGD divides factor costs by the temperature
    (ngd/NGDFactorizedBaseGH.h:122-129); the proximal path does not
    (proxgd/ProxGVIFactorizedBaseGH.h fact_cost_value).
    """
    costs = []
    t = temperature if temper_costs else 1.0
    for fb in graph.nonlinear:
        mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag, cov_off, fb.slice_offset)
        e_phi = mm.expectation_phi(
            fb.nodes, fb.weights, mu_k, cov_k, fb.cost_fn, fb.params,
            eval_dtype, nonneg=fb.nonneg_cost,
        )
        costs.append(e_phi / t)
    for lb in graph.linear:
        costs.append(
            mm.batch_linear_cost(lb, mu, cov_diag, cov_off) / t
        )
    if not costs:
        return jnp.zeros((0,), mu.dtype)
    return jnp.concatenate(costs)


def joint_cost(
    graph: FactorGraph,
    mu: jnp.ndarray,
    precision: BlockTridiag,
    temperature,
    temper_costs: bool = True,
) -> jnp.ndarray:
    """Total V(q) = sum_k E[psi_k](/T) + 0.5 log det Lambda
    (gvibase/GVI-GH-impl.h:175-197)."""
    cov_diag, cov_off, ld = gbp_covariance_logdet_assoc(precision)
    fc = factor_costs(graph, mu, cov_diag, cov_off, temperature, temper_costs)
    return jnp.sum(fc) + 0.5 * ld


def ngd_gradients(
    graph: FactorGraph,
    mu: jnp.ndarray,
    cov_diag: jnp.ndarray,
    cov_off: jnp.ndarray,
    temperature,
    eval_dtype=None,
) -> tuple[jnp.ndarray, BlockTridiag]:
    """Assemble joint (Vdmu [N,s], Vddmu block-tridiag).

    The NGD step downstream is d_precision = Vddmu - Lambda and
    d_mu = solve(Vddmu, -Vdmu) (ngd/NGD-GH-impl.h:21-63).
    """
    n, s = mu.shape
    vdmu_joint = jnp.zeros_like(mu)
    vddmu_joint = BlockTridiag.zeros(n, s, mu.dtype)
    for fb in graph.nonlinear:
        mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag, cov_off, fb.slice_offset)
        e_phi, e_xmu, e_xxt = mm.batch_moments(fb, mu_k, cov_k, eval_dtype)
        vdmu, vddmu = mm.ngd_local_gradients(e_phi, e_xmu, e_xxt, cov_k, temperature)
        vdmu_joint, vddmu_joint = scatter_gradients(
            fb.start, fb.nb, vdmu, vddmu, vdmu_joint, vddmu_joint,
            fb.slice_offset,
        )
    for lb in graph.linear:
        mu_k, _ = gather_marginals(lb.start, lb.nb, mu, cov_diag, cov_off, lb.slice_offset)
        vdmu, vddmu = mm.linear_local_gradients(
            lb.lam, lb.psi, lb.target_mu, lb.target_prec, lb.constant,
            mu_k, temperature,
        )
        vdmu_joint, vddmu_joint = scatter_gradients(
            lb.start, lb.nb, vdmu, vddmu, vdmu_joint, vddmu_joint,
            lb.slice_offset,
        )
    return vdmu_joint, vddmu_joint


def _bw_jko_step(b_k, s_k, cov_k, step_size, sqrtm_method="auto"):
    """The Bures-Wasserstein JKO proximal step as pseudo-gradients
    (proxgd/ProxGVIFactorizedBaseGH.h:64-113):

        M = I - s S_k;  Sig_half = M Sig M^T
        Sig_new = 0.5 Sig_half + s I + 0.5 sqrtm(Sig_half (Sig_half + 4 s I))
        mu_new  = mu - s b_k
        Vdmu = (mu_new - mu)/s = -b_k;  Vddmu = (Sig_new^{-1} - Prec_k)/s
    """
    d = cov_k.shape[-1]
    eye = jnp.eye(d, dtype=cov_k.dtype)
    m = eye[None] - step_size * s_k
    sig_half = einsum("kab,kbc,kdc->kad", m, cov_k, m)
    sig_new = (
        0.5 * sig_half
        + step_size * eye[None]
        + 0.5 * sqrtm_product(sig_half, step_size, sqrtm_method)
    )
    vdmu = -b_k
    vddmu = (spd_inv(sig_new) - spd_inv(cov_k)) / step_size
    return vdmu, vddmu


def prox_gradients(
    graph: FactorGraph,
    mu: jnp.ndarray,
    cov_diag: jnp.ndarray,
    cov_off: jnp.ndarray,
    step_size,
    sqrtm_method: str = "auto",
) -> tuple[jnp.ndarray, BlockTridiag]:
    """Per-factor Bures-Wasserstein JKO pseudo-gradients, summed into the
    joint (proxgd/ProxGVI-GH-impl.h:46-86); ``sqrtm_method`` picks the JKO
    root (:func:`..ops.psd.sqrtm_product`)."""
    n, s_dim = mu.shape
    dmu_joint = jnp.zeros_like(mu)
    dprec_joint = BlockTridiag.zeros(n, s_dim, mu.dtype)
    for fb in graph.nonlinear:
        mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag, cov_off, fb.slice_offset)
        e_phi, e_xmu, e_xxt = mm.batch_moments(fb, mu_k, cov_k)
        b_k, s_k = mm.bw_local_gradients(e_phi, e_xmu, e_xxt, cov_k)
        vdmu, vddmu = _bw_jko_step(b_k, s_k, cov_k, step_size, sqrtm_method)
        dmu_joint, dprec_joint = scatter_gradients(
            fb.start, fb.nb, vdmu, vddmu, dmu_joint, dprec_joint,
            fb.slice_offset,
        )
    for lb in graph.linear:
        # Closed-form BW grads (proxgd/ProxGVIFactorizedLinear.h
        # compute_BW_grads; note: no constant factor, unlike the NGD linear
        # path): b_k = Lam^T prec_t (Lam mu - Psi mu_t),
        # S_k = Lam^T prec_t Lam
        mu_k, cov_k = gather_marginals(lb.start, lb.nb, mu, cov_diag, cov_off, lb.slice_offset)
        resid = einsum("krd,kd->kr", lb.lam, mu_k) - einsum(
            "krt,kt->kr", lb.psi, lb.target_mu
        )
        b_k = einsum("krd,krs,ks->kd", lb.lam, lb.target_prec, resid)
        s_k = einsum("kra,krs,ksb->kab", lb.lam, lb.target_prec, lb.lam)
        vdmu, vddmu = _bw_jko_step(b_k, s_k, cov_k, step_size, sqrtm_method)
        dmu_joint, dprec_joint = scatter_gradients(
            lb.start, lb.nb, vdmu, vddmu, dmu_joint, dprec_joint,
            lb.slice_offset,
        )
    return dmu_joint, dprec_joint
