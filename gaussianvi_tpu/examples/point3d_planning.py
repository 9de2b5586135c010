"""3-D point-robot motion planning through an obstacle field.

The reference's ``CudaOperation_3dpR`` configuration
(helpers/CudaOperation.h:612-680): a point robot in 3-D, one collision ball
at (x, y, z), trilinear SDF lookup, hinge obstacle cost — wired into the
same anchors + minimum-acceleration-GP + collision factor graph as the
planar planner.  The reference loads its field from
``maps/3dpR/pRSDF3D.bin``; here the field is generated from an occupancy
grid (:func:`..factors.sdf_io.sdf_from_occupancy`) and round-trips through
the ``.npz`` map format (:func:`..factors.sdf_io.save_sdf` /
:func:`load_sdf`) when a ``map_file`` is given.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..factors.priors import fixed_prior, minimum_acc_prior
from ..factors.robots import make_point3d_obstacle_factor
from ..factors.sdf import SDF3D
from ..factors.sdf_io import load_sdf, save_sdf, sdf_from_occupancy
from ..inference import FactorGraph, GaussianState, GVIConfig, optimize
from ..ops import BlockTridiag


def box_obstacle_sdf3d(
    extent: float = 10.0,
    n_cells: int = 50,
    block_x=(4.0, 6.0),
    block_y=(3.0, 5.0),
    block_z=(2.0, 7.0),
    dtype=None,
) -> SDF3D:
    """Exact Euclidean SDF of one axis-aligned box obstacle, built through
    the occupancy-grid pipeline (the reference's maps are produced the same
    way offline in the parent VIMP project)."""
    cell = extent / (n_cells - 1)
    xs = np.linspace(0.0, extent, n_cells)
    # SDF3D layout: data[z, row(y), col(x)]
    zz, yy, xx = np.meshgrid(xs, xs, xs, indexing="ij")
    occ = (
        (xx >= block_x[0]) & (xx <= block_x[1])
        & (yy >= block_y[0]) & (yy <= block_y[1])
        & (zz >= block_z[0]) & (zz <= block_z[1])
    )
    return sdf_from_occupancy(occ, cell, origin=(0.0, 0.0, 0.0), dtype=dtype)


def build_point3d_planning(
    num_states: int = 20,
    total_time: float = 4.0,
    start=(1.0, 1.0, 4.5),
    goal=(8.5, 8.5, 4.5),
    cost_sigma: float = 5.0,
    epsilon: float = 0.4,
    radius: float = 0.2,
    gh_degree: int = 3,
    interp: str = "auto",
    marginal_quad: bool = True,
    map_file=None,
    dtype=None,
):
    """Factor graph for the 3-D point robot: state = [pos3; vel3] (s = 6).

    ``map_file``: optional path — the generated SDF is saved there and
    loaded back, exercising the map IO path the reference uses
    (CudaOperation.h:617 reads maps/3dpR/pRSDF3D.bin).
    ``interp``: see :func:`..factors.robots.make_point3d_obstacle_factor`.
    """
    dtype = dtype or jnp.zeros(0).dtype
    dim_x, state_dim = 3, 6
    dt = total_time / (num_states - 1)
    start = np.asarray(start, np.float64)
    goal = np.asarray(goal, np.float64)
    vel = (goal - start) / total_time

    sdf = box_obstacle_sdf3d(dtype=dtype)
    if map_file is not None:
        save_sdf(map_file, sdf)
        sdf = load_sdf(map_file, dtype=dtype)

    obstacle = make_point3d_obstacle_factor(
        sdf,
        np.arange(num_states),
        state_dim=state_dim,
        cost_sigma=cost_sigma,
        epsilon=epsilon,
        radius=radius,
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
    init_mu = np.concatenate([pos, np.tile(vel, (num_states, 1))], axis=1)
    init = GaussianState(
        jnp.asarray(init_mu, dtype),
        BlockTridiag.identity(num_states, state_dim, 10.0, dtype),
    )
    config = GVIConfig(
        niters=30, niters_lowtemp=20, step_size_base=0.9,
        temperature=0.1, high_temperature=1.0,
    )
    return graph, init, config, sdf


def run_point3d_planning(method: str = "ngd", **kwargs):
    graph, init, config, sdf = build_point3d_planning(**kwargs)
    final, hist = optimize(graph, init, config, method=method)
    return final, hist, sdf


if __name__ == "__main__":
    import jax

    from ..utils.compile_cache import configure_compile_cache

    jax.config.update("jax_enable_x64", True)  # the chain runs in float64
    configure_compile_cache()
    final, hist, sdf = run_point3d_planning()
    mu = np.asarray(final.mu)
    sd = np.asarray(sdf.signed_distance(jnp.asarray(mu[:, :3])))
    print("cost:", float(hist.cost[0]), "->", float(hist.cost[-1]))
    print("min signed distance along trajectory:", sd.min())
