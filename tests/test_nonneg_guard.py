"""Nonneg-phi contract guard (NonlinearFactorBatch.nonneg_cost).

The signed-weight sparse-GH sum of a NONNEGATIVE integrand (every
reference cost: squared residuals, hinge losses) can only go negative two
ways: f32 summation garbage (an accept-collapse class — poisoned to NaN
inside the ~4096-ulp rounding band,
moments._NONNEG_BAND), or genuine quadrature error of the signed-weight
rule on a kinked integrand (an f64 evaluation — and the reference —
computes and uses the same value: kept; e.g. the arm planner's initial
trajectory reads E[hinge] = -0.058 at ~2.7e4 ulps, and poisoning it froze
the run).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from gaussianvi_tpu.factors import moments as mm


def _setup(weights):
    # f32 pinned: the rounding band scales with the WORKING dtype's eps
    # (the suite runs under x64; the band class is an f32 phenomenon)
    f32 = jnp.float32
    nodes = jnp.zeros((len(weights), 2), f32)
    weights = jnp.asarray(weights, f32)
    mu = jnp.zeros((3, 2), f32)
    cov = jnp.broadcast_to(jnp.eye(2, dtype=f32), (3, 2, 2))
    cost = lambda x, p: jnp.asarray(1.0, f32)
    return nodes, weights, mu, cov, cost


# tot = -1e-4, sum|w phi| ~ 2.0: 420 ulps — inside the rounding band,
# above the sign-agnostic 64-ulp cancellation threshold
_BAND_GARBAGE = [1.0, -1.0001, 0.0, 0.0]
# tot = -0.5, sum|w phi| = 2.5: 1.7e6 ulps — genuine quadrature-scale
# negative, far outside the band
_QUAD_NEGATIVE = [1.0, -0.5, -0.5, -0.5]


class TestXLAPath:
    def test_band_negative_poisoned_when_nonneg(self):
        out = mm.expectation_phi(*_setup(_BAND_GARBAGE), None, nonneg=True)
        assert np.isnan(np.asarray(out)).all()

    def test_band_negative_kept_without_contract(self):
        out = mm.expectation_phi(*_setup(_BAND_GARBAGE), None, nonneg=False)
        np.testing.assert_allclose(np.asarray(out), -1e-4, rtol=1e-2)

    def test_quadrature_negative_passes_through(self):
        """A negative estimate OUTSIDE the rounding band is genuine
        quadrature error — f64 computes the same value, so it is kept
        (reference-faithful; the arm-planner freeze class)."""
        out = mm.expectation_phi(*_setup(_QUAD_NEGATIVE), None, nonneg=True)
        np.testing.assert_allclose(np.asarray(out), -0.5, rtol=1e-6)

    def test_zero_hinge_not_poisoned(self):
        """An exactly-zero cost (free-space hinge) has tot == absum == 0:
        no guard branch may fire."""
        f32 = jnp.float32
        nodes = jnp.zeros((4, 2), f32)
        weights = jnp.asarray([0.4, 0.3, 0.2, 0.1], f32)
        mu = jnp.zeros((2, 2), f32)
        cov = jnp.broadcast_to(jnp.eye(2, dtype=f32), (2, 2, 2))
        cost = lambda x, p: jnp.asarray(0.0, f32)
        out = mm.expectation_phi(nodes, weights, mu, cov, cost, None,
                                 nonneg=True)
        np.testing.assert_array_equal(np.asarray(out), 0.0)

    def test_healthy_positive_estimate_unchanged(self):
        nodes, _, mu, cov, _ = _setup(_QUAD_NEGATIVE)
        weights = jnp.asarray([0.25, 0.25, 0.25, 0.25])
        cost = lambda x, p: 1.0 + jnp.sum(x**2)
        with_g = mm.expectation_phi(nodes, weights, mu, cov, cost, None,
                                    nonneg=True)
        without = mm.expectation_phi(nodes, weights, mu, cov, cost, None,
                                     nonneg=False)
        np.testing.assert_array_equal(np.asarray(with_g),
                                      np.asarray(without))
        assert np.isfinite(np.asarray(with_g)).all()


class TestFactorBatchPath:
    def test_batch_phi_plumbs_contract(self):
        """batch_phi forwards fb.nonneg_cost."""
        from gaussianvi_tpu.factors.base import make_nonlinear_batch

        f32 = jnp.float32
        fb = make_nonlinear_batch(
            lambda x, p: jnp.asarray(1.0, f32), [0, 1], state_dim=2,
            gh_degree=3, nonneg_cost=True, dtype=f32,
        )
        # rig the weights so the total is a band-scale negative
        w = jnp.zeros_like(fb.weights).at[0].set(1.0).at[1].set(-1.0001)
        object.__setattr__(fb, "weights", w)
        mu_k = jnp.zeros((2, 2), f32)
        cov_k = jnp.broadcast_to(jnp.eye(2, dtype=f32), (2, 2, 2))
        out = mm.batch_phi(fb, mu_k, cov_k)
        assert np.isnan(np.asarray(out)).all()
