"""Batch trajectory state estimation on a chain factor graph.

The reference's flagship workload class (Barfoot et al. IJRR'20 batch
nonlinear estimation; reference gvibase/GVI-GH-GBP config): N states
[position; velocity], a fixed Gaussian anchor at t=0, minimum-acceleration
GP priors between consecutive states, and a nonlinear range measurement per
state.  Exercises every layer: linear + nonlinear factor batches, the
block-tridiagonal joint, GBP covariance, and both optimizers.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..factors import make_nonlinear_batch
from ..factors.priors import fixed_prior, minimum_acc_prior
from ..inference import FactorGraph, GaussianState, GVIConfig, optimize
from ..ops import BlockTridiag


def range_cost(x, params):
    """psi(x) = (r_meas - |pos - beacon|)^2 / (2 sig_r^2); x = [pos..., vel...]."""
    r_meas, beacon, sig_r_sq = params["r"], params["beacon"], params["sig_r_sq"]
    dim_x = beacon.shape[0]
    pos = x[:dim_x]
    dist = jnp.sqrt(jnp.sum((pos - beacon) ** 2) + 1e-12)
    return (r_meas - dist) ** 2 / (2.0 * sig_r_sq)


def simulate_trajectory(num_states, dim_x, dt, seed=0):
    """Ground-truth constant-velocity trajectory + noisy range measurements."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(1.0, 2.0, dim_x)
    v0 = rng.uniform(0.3, 0.8, dim_x)
    ts = np.arange(num_states) * dt
    pos = x0[None, :] + ts[:, None] * v0[None, :]
    beacon = np.full(dim_x, -1.0)
    sig_r = 0.1
    ranges = np.linalg.norm(pos - beacon, axis=1) + sig_r * rng.standard_normal(
        num_states
    )
    return pos, v0, beacon, ranges, sig_r


def build_chain_estimation(
    num_states: int = 16,
    dim_x: int = 1,
    dt: float = 0.1,
    gh_degree: int = 6,
    seed: int = 0,
    meas_sigma: float | None = None,
    anchor_cov: float = 0.01,
    marginal_quad: bool = True,
    dtype=None,
):
    """``marginal_quad``: the range cost reads only the position block
    (x[:dim_x]), so the measurement factor integrates over the position
    MARGINAL by default (factors.base.marginal_rule — e.g. 29 vs 137
    sigma points at dim_x=2/degree 4) with the velocity-block moment
    mass restored exactly in closed form; False keeps the full-state
    rule (rounds 1-4 behavior)."""
    dtype = dtype or jnp.zeros(0).dtype
    state_dim = 2 * dim_x
    pos, v0, beacon, ranges, sig_r = simulate_trajectory(
        num_states, dim_x, dt, seed
    )
    if meas_sigma is not None:
        sig_r = meas_sigma

    anchor_mu = np.concatenate([pos[0], v0])
    anchor = fixed_prior(0, anchor_mu, anchor_cov * np.eye(state_dim), dtype=dtype)
    gp = minimum_acc_prior(
        np.eye(dim_x), dt, num_states, dtype=dtype
    )
    meas = make_nonlinear_batch(
        range_cost,
        np.arange(num_states),
        state_dim=state_dim,
        nb=1,
        params={
            "r": jnp.asarray(ranges, dtype),
            "beacon": jnp.broadcast_to(
                jnp.asarray(beacon, dtype), (num_states, dim_x)
            ),
            "sig_r_sq": jnp.full(num_states, sig_r**2, dtype),
        },
        gh_degree=gh_degree,
        nonneg_cost=True,   # squared residual: E[phi] >= 0 by construction
        quad_rdim=dim_x if marginal_quad else None,
        dtype=dtype,
    )
    graph = FactorGraph(
        num_states=num_states,
        state_dim=state_dim,
        nonlinear=(meas,),
        linear=(anchor, gp),
    )

    # initial mean: anchor state replicated; initial precision: scaled identity
    init_mu = np.tile(anchor_mu, (num_states, 1))
    init_prec = BlockTridiag.identity(num_states, state_dim, 10.0, dtype)
    init = GaussianState(jnp.asarray(init_mu, dtype), init_prec)
    config = GVIConfig(
        niters=15, niters_lowtemp=15, step_size_base=0.9, niters_backtrack=10
    )
    return graph, init, config


def run_chain_estimation(method: str = "ngd", **kwargs):
    graph, init, config = build_chain_estimation(**kwargs)
    return optimize(graph, init, config, method=method)
