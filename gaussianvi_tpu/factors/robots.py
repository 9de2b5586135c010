"""Robot collision models: check-ball placement + DH forward kinematics.

Ports of the reference's device-side robot classes
(helpers/CudaOperation.h: CudaOperation_PlanarPR 454-530, _Quad 533-610,
_3dpR 612-680, _3dArm 683-793, ForwardKinematics 325-410).  Each model maps
a robot state to a set of collision-check sphere centers; the obstacle factor
composes this with an SDF lookup and the hinge loss.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .base import NonlinearFactorBatch, detect_slice_offset, marginal_rule
from .sdf import PlanarSDF, SDF3D, hinge_obstacle_cost
from ..quadrature import get_rule
from ..ops.precision import einsum, matmul


def planar_point_balls(pose: jnp.ndarray) -> jnp.ndarray:
    """Planar point robot: one ball at (x, y) (CudaOperation_PlanarPR)."""
    return pose[None, :2]


def planar_quad_balls(
    pose: jnp.ndarray, n_balls: int = 5, length: float = 5.0, radius: float = 1.0
) -> jnp.ndarray:
    """Planar quadrotor: n balls along the body axis
    (CudaOperation_Quad::vec_balls, CudaOperation.h:585-604).
    pose = (x, z, phi, ...)."""
    x, z, phi = pose[0], pose[1], pose[2]
    l_x = x - (length - radius * 1.5) * jnp.cos(phi) / 2.0
    l_z = z - (length - radius * 1.5) * jnp.sin(phi) / 2.0
    i = jnp.arange(n_balls, dtype=pose.dtype)
    pt_x = l_x + length * jnp.cos(phi) / n_balls * i
    pt_z = l_z + length * jnp.sin(phi) / n_balls * i
    return jnp.stack([pt_x, pt_z], axis=-1)


def point3d_balls(pose: jnp.ndarray) -> jnp.ndarray:
    """3-D point robot: one ball at (x, y, z) (CudaOperation_3dpR)."""
    return pose[None, :3]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DHForwardKinematics:
    """Denavit-Hartenberg chain with attached collision spheres
    (ForwardKinematics, CudaOperation.h:325-410)."""

    a: jnp.ndarray           # [J]
    alpha: jnp.ndarray       # [J]
    d: jnp.ndarray           # [J]
    theta_bias: jnp.ndarray  # [J]
    frames: jnp.ndarray      # [S] int: sphere -> joint frame
    centers: jnp.ndarray     # [S, 3] sphere center in its frame

    def _dh_matrix(self, i, theta):
        ct, st = jnp.cos(theta), jnp.sin(theta)
        ca, sa = jnp.cos(self.alpha[i]), jnp.sin(self.alpha[i])
        a_i, d_i = self.a[i], self.d[i]
        return jnp.array(
            [
                [ct, -st * ca, st * sa, a_i * ct],
                [st, ct * ca, -ct * sa, a_i * st],
                [0.0, sa, ca, d_i],
                [0.0, 0.0, 0.0, 1.0],
            ],
            theta.dtype,
        )

    def joint_transforms(self, theta: jnp.ndarray) -> jnp.ndarray:
        """Cumulative base->frame transforms T_0..T_{J-1}, [J, 4, 4],
        via a scan of 4x4 matmuls."""
        j = self.a.shape[0]
        mats = jax.vmap(self._dh_matrix)(jnp.arange(j), theta + self.theta_bias)

        def step(t, m):
            t_new = matmul(t, m)
            return t_new, t_new

        _, ts = jax.lax.scan(step, jnp.eye(4, dtype=theta.dtype), mats)
        return ts

    def sphere_centers(self, theta: jnp.ndarray) -> jnp.ndarray:
        """World positions of all collision spheres, [S, 3]
        (compute_transformed_sphere_centers)."""
        ts = self.joint_transforms(theta)
        t_s = ts[self.frames]                       # [S, 4, 4]
        rot = t_s[:, :3, :3]
        pos = t_s[:, :3, 3]
        return pos + einsum("sij,sj->si", rot, self.centers)




def sdf_lookup(sdf, interp: str):
    """The SDF's interpolation function for ``interp``: "gather" (direct
    corner lookups), "matmul" (one-hot hat contractions against the whole
    field — identical values, no gathers) or "auto", resolved against the
    platform the factor's program will compile for
    (:func:`..resolve.sdf_interp`)."""
    from .. import resolve

    if resolve.sdf_interp(resolve.target_platform(), interp) == "matmul":
        return sdf.signed_distance_matmul
    return sdf.signed_distance


def make_planar_obstacle_factor(
    sdf: PlanarSDF,
    start_indices,
    state_dim: int,
    cost_sigma: float = 15.5,
    epsilon: float = 0.5,
    radius: float = 1.0,
    slope: float = 1.0,
    balls_fn=planar_point_balls,
    gh_degree: int = 3,
    interp: str = "auto",
    marginal_quad: bool = True,
    dtype=None,
) -> NonlinearFactorBatch:
    """Per-state planar collision factor psi(x) = hinge(sd(balls(x)))
    (cost_obstacle_planar).  The SDF arrays are captured in the cost closure
    and live in device memory once, shared by all factors.

    ``interp``: see :func:`sdf_lookup`."""
    lookup = sdf_lookup(sdf, interp)

    def cost_fn(x, params):
        del params
        balls = balls_fn(x)
        sd = lookup(balls)
        return hinge_obstacle_cost(sd, epsilon, radius, cost_sigma, slope)

    # configuration-marginal quadrature (see marginal_rule): the known
    # balls_fns read pose[:2] / pose[:3]; custom balls_fns keep the
    # full-state rule
    rdim = None
    if marginal_quad:
        rdim = (2 if balls_fn is planar_point_balls
                else 3 if balls_fn is planar_quad_balls else None)
    if rdim is not None:
        nodes, weights = marginal_rule(state_dim, rdim, gh_degree)
    else:
        nodes, weights = get_rule(state_dim, gh_degree)
    dtype = dtype or jnp.zeros(0).dtype
    start_np = np.asarray(start_indices, np.int32)
    return NonlinearFactorBatch(
        start=jnp.asarray(start_np),
        slice_offset=detect_slice_offset(start_np),
        nodes=jnp.asarray(nodes, dtype),
        weights=jnp.asarray(weights, dtype),
        params=None,
        cost_fn=cost_fn,
        nb=1,
        nonneg_cost=True,   # hinge loss: phi >= 0 everywhere
        quad_rdim=rdim,
    )


def make_point3d_obstacle_factor(
    sdf: SDF3D,
    start_indices,
    state_dim: int,
    cost_sigma: float = 15.5,
    epsilon: float = 0.5,
    radius: float = 1.0,
    slope: float = 1.0,
    gh_degree: int = 3,
    interp: str = "auto",
    marginal_quad: bool = True,
    dtype=None,
) -> NonlinearFactorBatch:
    """3-D point-robot collision factor: one ball at (x, y, z) -> trilinear
    SDF lookup -> hinge loss (CudaOperation_3dpR::cost_obstacle_planar +
    vec_balls, helpers/CudaOperation.h:612-680; state = [pos3; vel3]).

    ``interp``: "auto" (resolved per platform), "gather" or "matmul"
    (one-hot hat contraction; mind the [Q, nz, rows] operand scaling —
    sdf.SDF3D.signed_distance_matmul)."""
    lookup = sdf_lookup(sdf, interp)

    def cost_fn(x, params):
        del params
        balls = point3d_balls(x)
        sd = lookup(balls)
        return hinge_obstacle_cost(sd, epsilon, radius, cost_sigma, slope)

    # position-marginal quadrature (see marginal_rule)
    rdim = 3 if marginal_quad else None
    if rdim is not None:
        nodes, weights = marginal_rule(state_dim, rdim, gh_degree)
    else:
        nodes, weights = get_rule(state_dim, gh_degree)
    dtype = dtype or jnp.zeros(0).dtype
    start_np = np.asarray(start_indices, np.int32)
    return NonlinearFactorBatch(
        start=jnp.asarray(start_np),
        slice_offset=detect_slice_offset(start_np),
        nodes=jnp.asarray(nodes, dtype),
        weights=jnp.asarray(weights, dtype),
        params=None,
        cost_fn=cost_fn,
        nb=1,
        nonneg_cost=True,   # hinge loss: phi >= 0 everywhere
        quad_rdim=rdim,
    )


def make_arm_obstacle_factor(
    sdf: SDF3D,
    fk: DHForwardKinematics,
    radii,
    start_indices,
    state_dim: int,
    cost_sigma: float = 15.5,
    epsilon: float = 0.5,
    slope: float = 1.0,
    gh_degree: int = 3,
    n_joints: int | None = None,
    interp: str = "auto",
    marginal_quad: bool = True,
    dtype=None,
) -> NonlinearFactorBatch:
    """Arm collision factor: DH FK -> sphere centers -> 3-D SDF -> hinge
    (CudaOperation_3dArm::cost_obstacle; state = [theta; theta_dot], the
    first n_joints entries are joint angles).  ``interp``: see
    :func:`sdf_lookup`; ``marginal_quad``: joint-angle-marginal
    quadrature (see :func:`marginal_rule`)."""
    radii = jnp.asarray(radii)
    nj = n_joints if n_joints is not None else state_dim // 2
    lookup = sdf_lookup(sdf, interp)

    def cost_fn(x, params):
        del params
        theta = x[:nj]
        centers = fk.sphere_centers(theta)
        sd = lookup(centers)
        return hinge_obstacle_cost(sd, epsilon, radii, cost_sigma, slope)

    rdim = nj if (marginal_quad and nj < state_dim) else None
    if rdim is not None:
        nodes, weights = marginal_rule(state_dim, rdim, gh_degree)
    else:
        nodes, weights = get_rule(state_dim, gh_degree)
    dtype = dtype or jnp.zeros(0).dtype
    start_np = np.asarray(start_indices, np.int32)
    return NonlinearFactorBatch(
        start=jnp.asarray(start_np),
        slice_offset=detect_slice_offset(start_np),
        nodes=jnp.asarray(nodes, dtype),
        weights=jnp.asarray(weights, dtype),
        params=None,
        cost_fn=cost_fn,
        nb=1,
        nonneg_cost=True,   # hinge loss: phi >= 0 everywhere
        quad_rdim=rdim,
    )
