"""SDF interpolation, hinge costs, and robot models vs direct oracles.

The bilinear/trilinear formulas are checked against a straight NumPy port of
the reference's C++ (helpers/CudaOperation.h:94-131), gradients against
jax.grad, and the DH forward kinematics against hand-computed 2-link planar
arm geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gaussianvi_tpu.factors.robots import (
    DHForwardKinematics,
    planar_point_balls,
    planar_quad_balls,
    make_planar_obstacle_factor,
)
from gaussianvi_tpu.factors.sdf import PlanarSDF, SDF3D, hinge_obstacle_cost


def reference_bilinear(data, origin, cell, point):
    """NumPy port of PlanarSDF::signed_distance (oracle)."""
    rows, cols = data.shape
    x = np.clip(point[0], origin[0], origin[0] + (cols - 1) * cell)
    y = np.clip(point[1], origin[1], origin[1] + (rows - 1) * cell)
    c = (x - origin[0]) / cell
    r = (y - origin[1]) / cell
    lr, lc = np.floor(r), np.floor(c)
    hr, hc = lr + 1, lc + 1
    lri, lci = int(lr), int(lc)
    hri, hci = min(int(hr), rows - 1), min(int(hc), cols - 1)
    return (
        (hr - r) * (hc - c) * data[lri, lci]
        + (r - lr) * (hc - c) * data[hri, lci]
        + (hr - r) * (c - lc) * data[lri, hci]
        + (r - lr) * (c - lc) * data[hri, hci]
    )


class TestPlanarSDF:
    def setup_method(self):
        rng = np.random.default_rng(0)
        self.data = rng.standard_normal((12, 10))
        self.origin = np.array([-1.0, -2.0])
        self.cell = 0.25
        self.sdf = PlanarSDF(
            jnp.asarray(self.data), jnp.asarray(self.origin),
            jnp.asarray(self.cell),
        )

    def test_matches_reference_formula(self):
        rng = np.random.default_rng(1)
        pts = rng.uniform(-1.5, 1.5, (50, 2))
        got = self.sdf.signed_distance(jnp.asarray(pts))
        expected = [
            reference_bilinear(self.data, self.origin, self.cell, p)
            for p in pts
        ]
        np.testing.assert_allclose(got, expected, rtol=1e-12)

    def test_exact_at_grid_nodes(self):
        for r in (0, 3, 11):
            for c in (0, 5, 9):
                p = self.origin + np.array([c, r]) * self.cell
                got = self.sdf.signed_distance(jnp.asarray(p))
                np.testing.assert_allclose(got, self.data[r, c], rtol=1e-12)

    def test_matmul_interp_matches_gather(self):
        """The one-hot hat-function matmul formulation is the SAME bilinear
        blend (clamping included) — the planning fast path must be
        value-identical to the gather port."""
        rng = np.random.default_rng(3)
        pts = jnp.asarray(rng.uniform(-4.0, 3.0, (200, 2)))
        a = self.sdf.signed_distance(pts)
        b = self.sdf.signed_distance_matmul(pts)
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)

    def test_matmul_interp_differentiable(self):
        g = jax.grad(lambda p: self.sdf.signed_distance_matmul(p))(
            jnp.asarray([0.3, 0.4])
        )
        g0 = jax.grad(lambda p: self.sdf.signed_distance(p))(
            jnp.asarray([0.3, 0.4])
        )
        np.testing.assert_allclose(g, g0, rtol=1e-8)

    def test_differentiable(self):
        g = jax.grad(lambda p: self.sdf.signed_distance(p))(
            jnp.asarray([0.3, 0.4])
        )
        assert np.isfinite(np.asarray(g)).all()
        # finite-difference check inside a cell
        eps = 1e-6
        for k in range(2):
            dp = np.zeros(2)
            dp[k] = eps
            fd = (
                self.sdf.signed_distance(jnp.asarray([0.3, 0.4]) + dp)
                - self.sdf.signed_distance(jnp.asarray([0.3, 0.4]) - dp)
            ) / (2 * eps)
            np.testing.assert_allclose(g[k], fd, rtol=1e-4)


class TestSDF3D:
    def test_exact_at_grid_nodes_and_linear(self):
        # a linear field f(x,y,z) = 2x - y + 3z is reproduced exactly
        origin = np.zeros(3)
        cell = 0.5
        zs, rs, cs = 4, 5, 6
        grid = np.zeros((zs, rs, cs))
        for z in range(zs):
            for r in range(rs):
                for c in range(cs):
                    x, y, zz = c * cell, r * cell, z * cell
                    grid[z, r, c] = 2 * x - y + 3 * zz
        sdf = SDF3D(jnp.asarray(grid), jnp.asarray(origin), jnp.asarray(cell))
        rng = np.random.default_rng(2)
        pts = rng.uniform(0.1, 1.3, (20, 3))
        expected = 2 * pts[:, 0] - pts[:, 1] + 3 * pts[:, 2]
        np.testing.assert_allclose(
            sdf.signed_distance(jnp.asarray(pts)), expected, rtol=1e-10
        )

    def test_matmul_interp_matches_gather(self):
        rng = np.random.default_rng(4)
        grid = rng.standard_normal((7, 9, 11))
        sdf = SDF3D(
            jnp.asarray(grid), jnp.asarray([-1.0, 0.5, 2.0]),
            jnp.asarray(0.4),
        )
        pts = jnp.asarray(rng.uniform(-3.0, 7.0, (150, 3)))
        np.testing.assert_allclose(
            sdf.signed_distance(pts), sdf.signed_distance_matmul(pts),
            rtol=1e-10, atol=1e-12,
        )


class TestHinge:
    def test_hinge_regions(self):
        sd = jnp.asarray([3.0, 1.0, -0.5])
        cost = hinge_obstacle_cost(sd, epsilon=0.5, radius=1.0, sigma=2.0)
        # sd=3 > 1.5 -> 0; sd=1 -> (0.5)^2*2; sd=-0.5 -> (2.0)^2*2
        np.testing.assert_allclose(cost, 0.25 * 2 + 4.0 * 2)


class TestRobots:
    def test_planar_quad_balls_reference(self):
        """Port of CudaOperation_Quad::vec_balls as oracle."""
        pose = np.array([1.0, 2.0, 0.3])
        n, L, radius = 5, 5.0, 1.0
        lx = pose[0] - (L - radius * 1.5) * np.cos(pose[2]) / 2
        lz = pose[1] - (L - radius * 1.5) * np.sin(pose[2]) / 2
        expected = np.stack(
            [
                [lx + L * np.cos(pose[2]) / n * i, lz + L * np.sin(pose[2]) / n * i]
                for i in range(n)
            ]
        )
        got = planar_quad_balls(jnp.asarray(pose), n, L, radius)
        np.testing.assert_allclose(got, expected, rtol=1e-12)

    def test_dh_two_link_planar(self):
        """2-link planar arm (alpha = d = 0): end effector at standard
        geometry."""
        l1, l2 = 1.0, 0.7
        fk = DHForwardKinematics(
            a=jnp.asarray([l1, l2]),
            alpha=jnp.zeros(2),
            d=jnp.zeros(2),
            theta_bias=jnp.zeros(2),
            frames=jnp.asarray([0, 1]),
            centers=jnp.zeros((2, 3)),
        )
        th1, th2 = 0.4, -0.6
        centers = fk.sphere_centers(jnp.asarray([th1, th2]))
        # joint 1 position (frame 0 origin): (l1 c1, l1 s1)
        np.testing.assert_allclose(
            centers[0], [l1 * np.cos(th1), l1 * np.sin(th1), 0.0], atol=1e-12
        )
        # end effector: (l1 c1 + l2 c12, l1 s1 + l2 s12)
        np.testing.assert_allclose(
            centers[1],
            [
                l1 * np.cos(th1) + l2 * np.cos(th1 + th2),
                l1 * np.sin(th1) + l2 * np.sin(th1 + th2),
                0.0,
            ],
            atol=1e-12,
        )

    def test_obstacle_factor_builds_and_evaluates(self):
        data = np.full((20, 20), 5.0)
        data[8:12, 8:12] = -1.0  # obstacle block
        sdf = PlanarSDF(
            jnp.asarray(data), jnp.asarray([0.0, 0.0]), jnp.asarray(0.5)
        )
        fb = make_planar_obstacle_factor(
            sdf, [0, 1, 2], state_dim=4, gh_degree=3
        )
        # far from the obstacle -> zero cost; inside -> positive
        far = jnp.asarray([0.5, 0.5, 0.0, 0.0])
        inside = jnp.asarray([5.0, 5.0, 0.0, 0.0])
        assert float(fb.cost_fn(far, None)) == 0.0
        assert float(fb.cost_fn(inside, None)) > 0.0
