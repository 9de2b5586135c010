"""Configuration-marginal quadrature (NonlinearFactorBatch.quad_rdim).

The collision factors' costs read only the leading configuration block of
the state, so their expectations integrate over the configuration MARGINAL
(reference analog: each factor's own ``dimension``-dim Pk subspace,
gvibase/GVIFactorizedBase.h:63-70).  moments.gh_moments assembles the
marginal rule's zero-padded nodes through the standard machinery and adds
the one closed-form conditional-moment correction to E[(x-mu)(x-mu)^T phi].

Key identity (proved in the gh_moments docstring): for a FULL TENSOR rule,
integrating a position-only integrand over all d dims equals the marginal
rule + exact lift IDENTICALLY (the velocity-axis quadrature integrates the
constant), so the padded-node assembly must match the full-dim assembly to
float roundoff — that is the exactness test below.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussianvi_tpu.factors import moments as mm
from gaussianvi_tpu.quadrature import get_rule


def _rand_spd(rng, k, d):
    a = rng.standard_normal((k, d, d))
    return a @ np.swapaxes(a, -1, -2) + d * np.eye(d)


def _pos_cost(x, params):
    """Nonlinear cost reading ONLY x[:2] of a 4-dim marginal."""
    del params
    p = x[:2]
    return jnp.sin(p[0]) + (p[0] * p[1]) ** 2 + 0.1 * p[1] ** 4


def _true_joint_cost(graph, state) -> float:
    """f64 joint cost under a full tensor deg-7 rule on the FULL state —
    the quadrature-accuracy oracle for plan adjudication."""
    import dataclasses

    from gaussianvi_tpu.inference.gvi import joint_cost
    from gaussianvi_tpu.ops.blocktridiag import BlockTridiag

    with jax.enable_x64(True):
        d = graph.state_dim
        nodes, weights = get_rule(d, 7, kind="full")
        fb = graph.nonlinear[0]
        fb64 = dataclasses.replace(
            fb,
            nodes=jnp.asarray(nodes, jnp.float64),
            weights=jnp.asarray(weights, jnp.float64),
            quad_rdim=None,
        )
        to64 = lambda x: (
            jnp.asarray(np.asarray(x), jnp.float64)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
            else jnp.asarray(x)
        )
        g64 = jax.tree.map(
            to64, dataclasses.replace(graph, nonlinear=(fb64,))
        )
        mu = to64(state.mu)
        prec = BlockTridiag(
            to64(state.precision.diag), to64(state.precision.off)
        )
        return float(
            joint_cost(g64, mu, prec, jnp.asarray(1.0, jnp.float64))
        )


class TestTensorRuleExactness:
    def test_full_vs_marginal_lift_f64(self):
        """Full-dim tensor rule == marginal tensor rule + lift, exactly."""
        d, r, deg, k = 4, 2, 5, 6
        rng = np.random.default_rng(0)
        mu = jnp.asarray(rng.standard_normal((k, d)))
        cov = jnp.asarray(_rand_spd(rng, k, d))
        with jax.enable_x64(True):
            mu64, cov64 = mu.astype(jnp.float64), cov.astype(jnp.float64)
            nf, wf = get_rule(d, deg, kind="full")
            full = mm.gh_moments(
                jnp.asarray(nf), jnp.asarray(wf), mu64, cov64,
                _pos_cost, None,
            )
            nr, wr = get_rule(r, deg, kind="full")
            nr_pad = np.concatenate(
                [nr, np.zeros((nr.shape[0], d - r))], axis=1
            )
            marg = mm.gh_moments(
                jnp.asarray(nr_pad), jnp.asarray(wr), mu64, cov64,
                _pos_cost, None, rdim=r,
            )
            for a, b in zip(full, marg):
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-12
                )

    def test_lift_correction_is_needed(self):
        """Without rdim the padded rule misses the velocity-block moment
        mass — the correction is load-bearing, not a no-op."""
        d, r, deg, k = 4, 2, 5, 4
        rng = np.random.default_rng(1)
        mu = jnp.asarray(rng.standard_normal((k, d)), jnp.float32)
        cov = jnp.asarray(_rand_spd(rng, k, d), jnp.float32)
        nr, wr = get_rule(r, deg, kind="full")
        nr_pad = jnp.asarray(
            np.concatenate([nr, np.zeros((nr.shape[0], d - r))], axis=1),
            jnp.float32,
        )
        wr = jnp.asarray(wr, jnp.float32)
        with_lift = mm.gh_moments(nr_pad, wr, mu, cov, _pos_cost, None,
                                  rdim=r)
        without = mm.gh_moments(nr_pad, wr, mu, cov, _pos_cost, None)
        # e_phi and e_xmu identical; e_xxt differs by the correction
        np.testing.assert_array_equal(np.asarray(with_lift[0]),
                                      np.asarray(without[0]))
        np.testing.assert_array_equal(np.asarray(with_lift[1]),
                                      np.asarray(without[1]))
        diff = np.abs(np.asarray(with_lift[2]) - np.asarray(without[2]))
        assert diff.max() > 1e-3


class TestFlagshipLift:
    def test_flagship_marginal_matches_full_e2e(self):
        """chain_estimation end-to-end: marginal (29-node) vs full-state
        (137-node) quadrature converge to the same posterior."""
        from gaussianvi_tpu.examples.chain_estimation import (
            build_chain_estimation,
        )
        from gaussianvi_tpu.inference import GVIConfig, optimize

        cfg = GVIConfig(niters=10, niters_lowtemp=10, step_size_base=0.9)
        g_m, init, _ = build_chain_estimation(
            num_states=12, dim_x=2, gh_degree=4
        )
        g_f, _, _ = build_chain_estimation(
            num_states=12, dim_x=2, gh_degree=4, marginal_quad=False
        )
        s_m, h_m = optimize(g_m, init, cfg, method="ngd")
        s_f, h_f = optimize(g_f, init, cfg, method="ngd")
        cm = np.asarray(h_m.cost, np.float64)
        cf = np.asarray(h_f.cost, np.float64)
        assert np.isfinite(cm).all() and np.isfinite(cf).all()
        rel = abs(cm[-1] - cf[-1]) / abs(cf[-1])
        assert rel < 1e-3, (cm[-1], cf[-1])
        np.testing.assert_allclose(
            np.asarray(s_m.mu), np.asarray(s_f.mu), atol=5e-3
        )


class TestPlannerIntegration:
    def test_planar_planner_marginal_matches_full(self):
        """End-to-end planar planner: marginal (13-node) vs full-state
        (41-node) quadrature agree within quadrature error, and the
        marginal factor batch carries ~3.2x fewer sigma points."""
        from gaussianvi_tpu.examples.planar_planning import (
            build_planar_planning,
        )
        from gaussianvi_tpu.inference import optimize

        g_m, init, cfg, _ = build_planar_planning(gh_degree=3)
        g_f, _, _, _ = build_planar_planning(
            gh_degree=3, marginal_quad=False
        )
        (fb_m,) = g_m.nonlinear
        (fb_f,) = g_f.nonlinear
        assert fb_m.quad_rdim == 2 and fb_f.quad_rdim is None
        assert fb_m.nodes.shape[0] * 3 <= fb_f.nodes.shape[0]
        # padded node columns are exactly zero
        np.testing.assert_array_equal(
            np.asarray(fb_m.nodes[:, 2:]), 0.0
        )
        s_m, h_m = optimize(g_m, init, cfg, method="ngd")
        s_f, h_f = optimize(g_f, init, cfg, method="ngd")
        cm = np.asarray(h_m.cost, np.float64)
        cf = np.asarray(h_f.cost, np.float64)
        assert np.isfinite(cm).all() and np.isfinite(cf).all()
        # Adjudication by a HIGH-ACCURACY oracle (full tensor deg-7 rule
        # on the full state, f64), not by raw reported costs: the two
        # deg-3 rules measure the kinked hinge differently, and a single
        # accept-flip can land the runs in different basins.  The marginal
        # default must produce a plan whose TRUE cost is at least as good
        # (round-5 measurement: 236.7 marginal vs 241.9 full).
        true_m = _true_joint_cost(g_m, s_m)
        true_f = _true_joint_cost(g_f, s_f)
        assert true_m <= true_f * 1.05, (true_m, true_f)

    def test_matmul_interp_factors_use_xla_quadrature(self):
        """The planner's matmul-interp factors integrate the configuration
        marginal: batch_moments is gh_moments with the batch's rdim lift."""
        from gaussianvi_tpu.examples.planar_planning import (
            build_planar_planning,
        )

        g_m, init, _, _ = build_planar_planning(gh_degree=3, interp="matmul")
        (fb,) = g_m.nonlinear
        assert fb.quad_rdim == 2
        mu_k = init.mu[:3]
        cov_k = jnp.broadcast_to(0.3 * jnp.eye(4), (3, 4, 4))
        got = mm.batch_moments(fb, mu_k, cov_k)
        ref = mm.gh_moments(fb.nodes, fb.weights, mu_k, cov_k, fb.cost_fn,
                            fb.params, rdim=2)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("builder", ["point3d", "quad", "arm"])
    def test_other_planners_build_and_descend(self, builder):
        from gaussianvi_tpu.inference import optimize

        if builder == "point3d":
            from gaussianvi_tpu.examples.point3d_planning import (
                build_point3d_planning,
            )

            g, init, cfg, _ = build_point3d_planning()
            assert g.nonlinear[0].quad_rdim == 3
        elif builder == "quad":
            from gaussianvi_tpu.examples.quadrotor_planning import (
                build_quadrotor_planning,
            )

            g, init, cfg = build_quadrotor_planning()[:3]
            assert g.nonlinear[0].quad_rdim == 3
        else:
            from gaussianvi_tpu.examples.arm_planning import (
                build_arm_planning,
            )

            g, init, cfg = build_arm_planning()[:3]
            assert g.nonlinear[0].quad_rdim is not None
        _, hist = optimize(g, init, cfg, method="ngd")
        cost = np.asarray(hist.cost, np.float64)
        assert np.isfinite(cost).all()
        assert cost[-1] <= cost[0]
