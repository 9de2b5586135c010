"""XLA sigma-point moments (factors/moments.py) vs a tensor-product
Gauss-Hermite oracle, at the (K factors, d dims, M nodes) classes the
shipped factor batches use, with the configuration-marginal lift and the
nonneg guard."""

import jax.numpy as jnp
import numpy as np
import pytest

from gaussianvi_tpu.factors import make_nonlinear_batch
from gaussianvi_tpu.factors import moments as mm
from gaussianvi_tpu.factors.base import marginal_rule
from gaussianvi_tpu.quadrature import get_rule


def _poly_cost(r):
    """A cubic in the leading r dims: every moment up to E[xx^T phi] is a
    polynomial of degree <= 5, which both rules integrate exactly."""
    def cost(x, params):
        del params
        p = x[:r]
        return (1.0 + jnp.sum(p * p) + 0.3 * p[0] ** 3
                + 0.2 * jnp.prod(p[: min(r, 2)]))
    return cost


def _problem(k, d, seed):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((k, d))
    a = rng.standard_normal((k, d, d)) * 0.4
    cov = a @ np.swapaxes(a, -1, -2) + 0.3 * np.eye(d)
    return jnp.asarray(mu), jnp.asarray(cov)


def _oracle(mu, cov, cost, d):
    """E[phi], E[(x-mu) phi], E[(x-mu)(x-mu)^T phi] by a 3-point-per-dim
    tensor Gauss-Hermite rule (exact to degree 5)."""
    nodes, weights = get_rule(d, 3, kind="full")
    return mm.gh_moments(jnp.asarray(nodes), jnp.asarray(weights), mu, cov,
                         cost, None)


# (K, d, sparse degree): the chain-estimation (s=4), 1-D Barfoot, planar
# quadrotor (s=6) and point-robot classes
_CLASSES = [(8, 4, 3), (16, 2, 3), (5, 1, 10), (3, 6, 3), (2, 8, 3)]


@pytest.mark.parametrize("k,d,deg", _CLASSES)
def test_gh_moments_match_tensor_oracle(k, d, deg):
    mu, cov = _problem(k, d, seed=k + d)
    cost = _poly_cost(d)
    nodes, weights = get_rule(d, deg)
    got = mm.gh_moments(jnp.asarray(nodes), jnp.asarray(weights), mu, cov,
                        cost, None)
    for a, b in zip(got, _oracle(mu, cov, cost, d)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("k,d,deg", _CLASSES)
def test_expectation_phi_matches_tensor_oracle(k, d, deg):
    mu, cov = _problem(k, d, seed=10 + k + d)
    cost = _poly_cost(d)
    nodes, weights = get_rule(d, deg)
    got = mm.expectation_phi(jnp.asarray(nodes), jnp.asarray(weights), mu,
                             cov, cost, None, nonneg=True)
    ref = _oracle(mu, cov, cost, d)[0]
    np.testing.assert_allclose(got, ref, rtol=1e-9)


@pytest.mark.parametrize("d,r", [(4, 2), (6, 3), (8, 4)])
def test_marginal_lift_matches_full_state_oracle(d, r):
    """An r-dim rule zero-padded to d, with the closed-form lift, gives
    the FULL-state moments of a cost that reads only x[:r]."""
    mu, cov = _problem(4, d, seed=d)
    cost = _poly_cost(r)
    fb = make_nonlinear_batch(cost, np.arange(4), state_dim=d,
                              gh_degree=3, quad_rdim=r)
    assert fb.quad_rdim == r
    nodes, _ = marginal_rule(d, r, 3)
    np.testing.assert_array_equal(np.asarray(fb.nodes), nodes)
    got = mm.batch_moments(fb, mu, cov)
    for a, b in zip(got, _oracle(mu, cov, cost, d)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_batch_phi_keeps_healthy_nonneg_estimates():
    """The nonneg contract leaves a healthy positive E[phi] untouched
    (f32 inputs: the guard's band scales with the working eps)."""
    mu, cov = _problem(6, 4, seed=3)
    f32 = jnp.float32
    fb = make_nonlinear_batch(_poly_cost(4), np.arange(6), state_dim=4,
                              gh_degree=3, nonneg_cost=True, dtype=f32)
    got = mm.batch_phi(fb, mu.astype(f32), cov.astype(f32))
    ref = _oracle(mu, cov, _poly_cost(4), 4)[0]
    assert np.isfinite(np.asarray(got)).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_centered_bf16_offsets_stay_close():
    """moments_eval_dtype: bf16 CENTERED offsets keep E[phi] within the
    documented envelope of the full-precision value."""
    mu, cov = _problem(8, 4, seed=5)
    nodes, weights = get_rule(4, 3)
    args = (jnp.asarray(nodes), jnp.asarray(weights), mu + 20.0, cov,
            _poly_cost(2), None)
    full = mm.expectation_phi(*args)
    bf16 = mm.expectation_phi(*args, eval_dtype=jnp.bfloat16)
    np.testing.assert_allclose(bf16, full, rtol=3e-3)
