"""Planar point-robot motion planning through an obstacle field.

The reference's parent application (VIMP): a GVI trajectory optimizer whose
factor graph is start/goal anchors + minimum-acceleration GP priors +
per-state SDF collision factors (helpers/CudaOperation.h CudaOperation_PlanarPR
+ the gvibase/GVI-GH-Cuda drivers).  Here the whole problem is one jitted
NGD run.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..factors.priors import fixed_prior, minimum_acc_prior
from ..factors.robots import make_planar_obstacle_factor, planar_point_balls
from ..factors.sdf import PlanarSDF
from ..inference import FactorGraph, GaussianState, GVIConfig, optimize
from ..ops import BlockTridiag


def block_obstacle_sdf(
    extent: float = 10.0,
    n_cells: int = 100,
    block_x=(4.0, 6.0),
    block_y=(3.0, 5.0),
    dtype=None,
) -> PlanarSDF:
    """Euclidean SDF of one axis-aligned box obstacle (off the start-goal
    diagonal by default, so the planner is not started at a symmetry
    saddle)."""
    dtype = dtype or jnp.zeros(0).dtype
    cell = extent / (n_cells - 1)
    xs = np.linspace(0.0, extent, n_cells)
    xx, yy = np.meshgrid(xs, xs, indexing="xy")
    # distance to the box block_x x block_y (positive outside, negative in)
    dx = np.maximum(block_x[0] - xx, xx - block_x[1])
    dy = np.maximum(block_y[0] - yy, yy - block_y[1])
    outside = np.hypot(np.maximum(dx, 0.0), np.maximum(dy, 0.0))
    inside = np.minimum(np.maximum(dx, dy), 0.0)
    sd = outside + inside
    return PlanarSDF(
        jnp.asarray(sd, dtype), jnp.asarray([0.0, 0.0], dtype),
        jnp.asarray(cell, dtype),
    )


def build_planar_planning(
    num_states: int = 20,
    total_time: float = 4.0,
    start=(1.0, 1.0),
    goal=(8.5, 8.5),
    cost_sigma: float = 5.0,
    epsilon: float = 0.4,
    radius: float = 0.2,
    gh_degree: int = 3,
    interp: str = "auto",
    marginal_quad: bool = True,
    dtype=None,
):
    """``interp``: SDF interpolation of the obstacle factor -- "gather",
    "matmul" (gather-free one-hot hat-function contraction against the
    whole field, factors.sdf.PlanarSDF.signed_distance_matmul) or "auto"
    (resolved per platform, gaussianvi_tpu.resolve.sdf_interp)."""
    dtype = dtype or jnp.zeros(0).dtype
    dim_x, state_dim = 2, 4
    dt = total_time / (num_states - 1)
    start = np.asarray(start, np.float64)
    goal = np.asarray(goal, np.float64)
    vel = (goal - start) / total_time

    sdf = block_obstacle_sdf(dtype=dtype)
    obstacle = make_planar_obstacle_factor(
        sdf,
        np.arange(num_states),
        state_dim=state_dim,
        cost_sigma=cost_sigma,
        epsilon=epsilon,
        radius=radius,
        balls_fn=planar_point_balls,
        gh_degree=gh_degree,
        interp=interp,
        marginal_quad=marginal_quad,
        dtype=dtype,
    )
    anchors = []
    for idx, p in ((0, start), (num_states - 1, goal)):
        anchors.append(
            fixed_prior(
                idx, np.concatenate([p, vel]), 0.01 * np.eye(state_dim),
                dtype=dtype,
            )
        )
    gp = minimum_acc_prior(1.0 * np.eye(dim_x), dt, num_states, dtype=dtype)
    graph = FactorGraph(
        num_states=num_states,
        state_dim=state_dim,
        nonlinear=(obstacle,),
        linear=(*anchors, gp),
    )

    # straight-line initialization (goes through the obstacle)
    ts = np.linspace(0.0, 1.0, num_states)[:, None]
    pos = start[None, :] + ts * (goal - start)[None, :]
    init_mu = np.concatenate(
        [pos, np.tile(vel, (num_states, 1))], axis=1
    )
    init = GaussianState(
        jnp.asarray(init_mu, dtype),
        BlockTridiag.identity(num_states, state_dim, 10.0, dtype),
    )
    config = GVIConfig(
        niters=30, niters_lowtemp=20, step_size_base=0.9,
        temperature=0.1, high_temperature=1.0,
    )
    return graph, init, config, sdf


def run_planar_planning(method: str = "ngd", **kwargs):
    graph, init, config, sdf = build_planar_planning(**kwargs)
    final, hist = optimize(graph, init, config, method=method)
    return final, hist, sdf
