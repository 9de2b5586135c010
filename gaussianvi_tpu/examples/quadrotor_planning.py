"""Planar quadrotor motion planning (CudaOperation_Quad equivalent).

The reference's planar quadrotor model (helpers/CudaOperation.h:533-610):
state [x, z, phi, vx, vz, phi_dot] with 5 collision-check balls along the
body axis; hinge-loss obstacle cost against a planar SDF; minimum-acc GP
prior over the 3 pose coordinates.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..factors.base import NonlinearFactorBatch
from ..factors.priors import fixed_prior, minimum_acc_prior
from ..factors.robots import planar_quad_balls
from ..factors.sdf import hinge_obstacle_cost
from ..inference import FactorGraph, GaussianState, GVIConfig, optimize
from ..ops import BlockTridiag
from .planar_planning import block_obstacle_sdf


def build_quadrotor_planning(
    num_states: int = 12,
    total_time: float = 3.0,
    cost_sigma: float = 3.0,
    epsilon: float = 0.3,
    radius: float = 1.0,
    n_balls: int = 5,
    body_length: float = 5.0,
    gh_degree: int = 2,
    interp: str = "auto",
    dtype=None,
):
    dtype = dtype or jnp.zeros(0).dtype
    dim_pose, state_dim = 3, 6
    dt = total_time / (num_states - 1)
    start = np.array([2.0, 1.0, 0.0])
    goal = np.array([16.0, 8.0, 0.0])
    vel = (goal - start) / total_time

    sdf = block_obstacle_sdf(
        extent=20.0, n_cells=120, block_x=(8.0, 11.0), block_y=(2.0, 5.0),
        dtype=dtype,
    )

    from ..factors.robots import sdf_lookup

    lookup = sdf_lookup(sdf, interp)

    def quad_cost(x, params):
        del params
        balls = planar_quad_balls(x, n_balls, body_length, radius)
        sd = lookup(balls)
        return hinge_obstacle_cost(
            sd, epsilon, radius, cost_sigma, slope=5.0
        )

    # pose-marginal quadrature: quad_cost reads (x, z, phi) = x[:3] only
    # (factors.robots.marginal_rule; exact lift in moments.gh_moments)
    from ..factors.robots import marginal_rule

    nodes, weights = marginal_rule(state_dim, 3, gh_degree)
    obstacle = NonlinearFactorBatch(
        start=jnp.arange(num_states, dtype=jnp.int32),
        slice_offset=0,
        nodes=jnp.asarray(nodes, dtype),
        weights=jnp.asarray(weights, dtype),
        params=None,
        cost_fn=quad_cost,
        nb=1,
        nonneg_cost=True,
        quad_rdim=3,
    )
    anchors = [
        fixed_prior(
            0, np.concatenate([start, vel]), 0.01 * np.eye(state_dim),
            dtype=dtype,
        ),
        fixed_prior(
            num_states - 1, np.concatenate([goal, vel]),
            0.01 * np.eye(state_dim), dtype=dtype,
        ),
    ]
    gp = minimum_acc_prior(np.eye(dim_pose), dt, num_states, dtype=dtype)
    graph = FactorGraph(
        num_states=num_states, state_dim=state_dim,
        nonlinear=(obstacle,), linear=(*anchors, gp),
    )
    ts = np.linspace(0.0, 1.0, num_states)[:, None]
    pose = start[None] + ts * (goal - start)[None]
    init_mu = np.concatenate([pose, np.tile(vel, (num_states, 1))], axis=1)
    init = GaussianState(
        jnp.asarray(init_mu, dtype),
        BlockTridiag.identity(num_states, state_dim, 10.0, dtype),
    )
    config = GVIConfig(niters=20, niters_lowtemp=20, step_size_base=0.9)
    return graph, init, config, sdf


def run_quadrotor_planning(method: str = "ngd", **kwargs):
    graph, init, config, sdf = build_quadrotor_planning(**kwargs)
    final, hist = optimize(graph, init, config, method=method)
    return final, hist, sdf
