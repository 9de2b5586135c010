"""Time-sharded GVI: the trajectory axis over the mesh.

Completes the sequence-parallel story of SURVEY.md section 5.7 at the
training-step level: with the chain engine of :mod:`.chain_seqpar`, the FULL
GVI loop — covariance, factor expectations, joint gradient assembly,
natural-gradient solve, lockstep line search, temperature schedule, EMA,
convergence freeze — runs with the N states sharded over an ``sp`` mesh
axis.  The iteration body is the SAME code as the single-device path
(:func:`..inference.optimize.run_gvi`) driven through
:class:`TimeShardEngine`.  Per-iteration communication is O(P) small
messages: the chain engine's segment summaries, one mu/cov halo exchange
for the factors straddling segment boundaries, one reverse halo for their
gradient contributions, and the psum'd line-search costs.

Layout ("chain layout"): factors are stored per-state/per-edge so they
shard with the states they touch —

* every nonlinear batch must be unary (nb=1) with exactly one factor per
  state, row j belonging to state j;
* binary (nb=2) linear batches are stored per-edge, padded to N rows with
  ``constant = 0`` (closed-form linear costs and gradients scale by the
  constant, so padding rows contribute exact zeros; the prox path masks
  padded rows explicitly, since the JKO step of even a zero potential
  carries entropy flow);
* unary linear batches are stored per-state, masked the same way.

:func:`to_chain_layout` converts a standard :class:`FactorGraph` (e.g. from
``build_chain_estimation``) into this layout on the host.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from .. import resolve
from ..factors import moments as mm
from ..inference.config import GVIConfig
from ..inference.graph import FactorGraph, GaussianState
from ..inference.gvi import _bw_jko_step
from ..inference.optimize import GVIHistory, concat_factor_costs, run_gvi
from ..ops.blocktridiag import BlockTridiag, in_float64
from .chain_seqpar import gbp_covariance_logdet_seqpar, solve_seqpar
from ..ops.precision import einsum


def to_chain_layout(graph: FactorGraph) -> FactorGraph:
    """Reorder a chain-structured FactorGraph into per-state/per-edge rows.

    Host-side (concrete ``start`` arrays required).  Raises if a nonlinear
    batch is not exactly one-unary-factor-per-state.
    """
    n = graph.num_states
    nl_out = []
    for fb in graph.nonlinear:
        if fb.nb != 1:
            raise ValueError("time sharding needs unary nonlinear factors")
        order = np.argsort(np.asarray(fb.start))
        starts = np.asarray(fb.start)[order]
        if not np.array_equal(starts, np.arange(n)):
            raise ValueError(
                "each nonlinear batch must cover every state exactly once"
            )
        perm = jnp.asarray(order)
        nl_out.append(replace(
            fb,
            start=jnp.asarray(starts),
            slice_offset=0,
            params=jax.tree.map(lambda p: p[perm], fb.params)
            if fb.params is not None else None,
        ))

    lin_out = []
    for lb in graph.linear:
        starts = np.asarray(lb.start)
        if len(np.unique(starts)) != len(starts):
            raise ValueError("duplicate linear-factor starts unsupported")

        def spread(x):
            out = jnp.zeros((n,) + x.shape[1:], x.dtype)
            return out.at[jnp.asarray(starts)].set(x)

        lin_out.append(replace(
            lb,
            start=jnp.arange(n, dtype=lb.start.dtype),
            slice_offset=0,
            lam=spread(lb.lam),
            psi=spread(lb.psi),
            target_mu=spread(lb.target_mu),
            target_prec=spread(lb.target_prec),
            constant=spread(lb.constant),  # missing rows: constant 0
        ))
    return FactorGraph(
        num_states=n,
        state_dim=graph.state_dim,
        nonlinear=tuple(nl_out),
        linear=tuple(lin_out),
    )


def _right_halo(x, axis_name):
    """Send this device's value to its RIGHT neighbor; receive from the
    left (device 0 receives the last device's value — callers arrange for
    that wrapped value to be exactly zero)."""
    p = lax.psum(1, axis_name)
    return lax.ppermute(x, axis_name, [(i, (i + 1) % p) for i in range(p)])


def _left_halo(x, axis_name):
    """Receive the RIGHT neighbor's value (wrapped for the last device)."""
    p = lax.psum(1, axis_name)
    return lax.ppermute(x, axis_name, [(i, (i - 1) % p) for i in range(p)])


def _edge_marginals(mu_l, cov_diag, cov_off, axis_name):
    """Per-edge (mu [Nl, 2s], cov [Nl, 2s, 2s]) with the boundary edge's
    right state haloed from the neighbor."""
    nbr_mu = _left_halo(mu_l[0], axis_name)
    nbr_cd = _left_halo(cov_diag[0], axis_name)
    mu_r = jnp.concatenate([mu_l[1:], nbr_mu[None]], axis=0)
    cd_r = jnp.concatenate([cov_diag[1:], nbr_cd[None]], axis=0)
    mu_e = jnp.concatenate([mu_l, mu_r], axis=-1)
    top = jnp.concatenate([cov_diag, cov_off], axis=-1)
    bot = jnp.concatenate([jnp.swapaxes(cov_off, -1, -2), cd_r], axis=-1)
    return mu_e, jnp.concatenate([top, bot], axis=-2)


def _scatter_edge(vd, vdd, vdmu, vddmu_d, vddmu_o, s, axis_name):
    """Scatter per-edge (vd [Nl, 2s], vdd [Nl, 2s, 2s]) contributions into
    local per-state accumulators.  The right-state pieces of rows 0..Nl-2
    belong to local states 1..Nl-1; the boundary row's go to the right
    neighbor via one reverse halo (the wrapped contribution entering device
    0 comes from the padded globally-last edge, hence exact zeros)."""
    vdmu = vdmu + vd[:, :s]
    vddmu_d = vddmu_d + vdd[:, :s, :s]
    vddmu_o = vddmu_o + vdd[:, :s, s:]
    vdmu = vdmu.at[1:].add(vd[:-1, s:])
    vddmu_d = vddmu_d.at[1:].add(vdd[:-1, s:, s:])
    halo_mu = _right_halo(vd[-1, s:], axis_name)
    halo_dd = _right_halo(vdd[-1, s:, s:], axis_name)
    vdmu = vdmu.at[0].add(halo_mu)
    vddmu_d = vddmu_d.at[0].add(halo_dd)
    return vdmu, vddmu_d, vddmu_o


class TimeShardEngine:
    """Engine hooks with the trajectory (time) axis sharded over ``sp``.

    The local state is the segment ``mu_l [Nl, s]`` with precision blocks
    ``BlockTridiag(diag [Nl, s, s], off [Nl, s, s])`` in the PADDED edge
    layout of :mod:`.chain_seqpar` (row j's off block is the edge to the
    next state; the globally-last row is zero).
    """

    # loop-carried scalars derive only from psum'd (sp-invariant) values
    carry_axes: tuple[str, ...] = ()

    def __init__(self, graph: FactorGraph, config, axis: str = "sp",
                 platform: str | None = None):
        self.graph = graph
        self.config = config
        self.axis = axis
        self.sqrtm_method = resolve.sqrtm_method(
            platform or resolve.target_platform(), "auto"
        )

    # -- chain ---------------------------------------------------------------
    def cov_logdet(self, prec: BlockTridiag):
        return in_float64(gbp_covariance_logdet_seqpar)(
            prec.diag, prec.off, self.axis
        )

    # -- costs ---------------------------------------------------------------
    def factor_costs_raw(self, mu_l, cov_diag, cov_off, eval_dtype=None):
        g = self.graph
        out = []
        mu_e = cov_e = None
        for fb in g.nonlinear:
            out.append(mm.expectation_phi(
                fb.nodes, fb.weights, mu_l, cov_diag, fb.cost_fn, fb.params,
                eval_dtype, nonneg=fb.nonneg_cost,
            ))
        for lb in g.linear:
            if lb.nb == 2 and mu_e is None:
                mu_e, cov_e = _edge_marginals(
                    mu_l, cov_diag, cov_off, self.axis
                )
            mk, ck = (mu_l, cov_diag) if lb.nb == 1 else (mu_e, cov_e)
            out.append(mm.linear_cost(
                lb.lam, lb.psi, lb.target_mu, lb.target_prec, lb.constant,
                mk, ck,
            ))
        return tuple(out)

    def reduce_fc(self, fc_tuple):
        local = jnp.zeros(())
        for f in fc_tuple:
            local = local + jnp.sum(f)
        return lax.psum(local, self.axis)

    # -- gradients -----------------------------------------------------------
    def ngd_gradients(self, mu_l, cov_diag, cov_off, temperature,
                      eval_dtype=None):
        g = self.graph
        nl, s = mu_l.shape
        vdmu = jnp.zeros_like(mu_l)
        vddmu_d = jnp.zeros((nl, s, s), mu_l.dtype)
        vddmu_o = jnp.zeros((nl, s, s), mu_l.dtype)

        for fb in g.nonlinear:
            e_phi, e_xmu, e_xxt = mm.gh_moments(
                fb.nodes, fb.weights, mu_l, cov_diag, fb.cost_fn, fb.params,
                eval_dtype, rdim=fb.quad_rdim,
            )
            vd, vdd = mm.ngd_local_gradients(
                e_phi, e_xmu, e_xxt, cov_diag, temperature
            )
            vdmu = vdmu + vd
            vddmu_d = vddmu_d + vdd

        mu_e = cov_e = None
        for lb in g.linear:
            if lb.nb == 1:
                vd, vdd = mm.linear_local_gradients(
                    lb.lam, lb.psi, lb.target_mu, lb.target_prec,
                    lb.constant, mu_l, temperature,
                )
                vdmu = vdmu + vd
                vddmu_d = vddmu_d + vdd
            else:
                if mu_e is None:
                    mu_e, cov_e = _edge_marginals(
                        mu_l, cov_diag, cov_off, self.axis
                    )
                vd, vdd = mm.linear_local_gradients(
                    lb.lam, lb.psi, lb.target_mu, lb.target_prec,
                    lb.constant, mu_e, temperature,
                )  # vd [Nl, 2s], vdd [Nl, 2s, 2s]; padded rows exact zero
                vdmu, vddmu_d, vddmu_o = _scatter_edge(
                    vd, vdd, vdmu, vddmu_d, vddmu_o, s, self.axis
                )
        return vdmu, BlockTridiag(vddmu_d, vddmu_o)

    def prox_gradients(self, mu_l, cov_diag, cov_off, step_size):
        """Per-factor Bures-Wasserstein JKO pseudo-gradients in chain
        layout.  Padded linear rows (constant == 0) are masked out: unlike
        the closed-form NGD gradients, the JKO step of a ZERO potential
        still moves the covariance (its Wasserstein entropy flow), so a
        padding row would otherwise contribute spurious expansion."""
        g = self.graph
        nl, s = mu_l.shape
        dmu = jnp.zeros_like(mu_l)
        dpd = jnp.zeros((nl, s, s), mu_l.dtype)
        dpo = jnp.zeros((nl, s, s), mu_l.dtype)

        for fb in g.nonlinear:
            e_phi, e_xmu, e_xxt = mm.gh_moments(
                fb.nodes, fb.weights, mu_l, cov_diag, fb.cost_fn, fb.params,
                rdim=fb.quad_rdim,
            )
            b_k, s_k = mm.bw_local_gradients(e_phi, e_xmu, e_xxt, cov_diag)
            vd, vdd = _bw_jko_step(
                b_k, s_k, cov_diag, step_size, self.sqrtm_method
            )
            dmu = dmu + vd
            dpd = dpd + vdd

        mu_e = cov_e = None
        for lb in g.linear:
            if lb.nb == 2 and mu_e is None:
                mu_e, cov_e = _edge_marginals(
                    mu_l, cov_diag, cov_off, self.axis
                )
            mk, ck = (mu_l, cov_diag) if lb.nb == 1 else (mu_e, cov_e)
            # closed-form BW grads (proxgd/ProxGVIFactorizedLinear.h
            # compute_BW_grads — note: no constant factor in the grads)
            resid = einsum("krd,kd->kr", lb.lam, mk) - einsum(
                "krt,kt->kr", lb.psi, lb.target_mu
            )
            b_k = einsum("krd,krs,ks->kd", lb.lam, lb.target_prec, resid)
            s_k = einsum(
                "kra,krs,ksb->kab", lb.lam, lb.target_prec, lb.lam
            )
            vd, vdd = _bw_jko_step(b_k, s_k, ck, step_size,
                                   self.sqrtm_method)
            mask = (lb.constant != 0).astype(mu_l.dtype)
            vd = vd * mask[:, None]
            vdd = vdd * mask[:, None, None]
            if lb.nb == 1:
                dmu = dmu + vd
                dpd = dpd + vdd
            else:
                dmu, dpd, dpo = _scatter_edge(
                    vd, vdd, dmu, dpd, dpo, s, self.axis
                )
        return dmu, BlockTridiag(dpd, dpo)

    # -- solve ---------------------------------------------------------------
    def solve_pair(self, bt_main: BlockTridiag, bt_fallback: BlockTridiag,
                   rhs):
        solve = in_float64(solve_seqpar)
        x_main = solve(bt_main.diag, bt_main.off, rhs, self.axis)
        x_fb = solve(bt_fallback.diag, bt_fallback.off, rhs, self.axis)
        return x_main, x_fb

    def all_finite(self, x) -> jnp.ndarray:
        """Agreed GLOBALLY so all devices take the same fallback branch."""
        n_bad = lax.psum(
            jnp.sum(jnp.logical_not(jnp.isfinite(x))), self.axis
        )
        return n_bad == 0


def _chain_graph_specs(graph: FactorGraph) -> FactorGraph:
    # dataclasses.replace keeps ALL static metadata (nb, cost fns,
    # slice_offset, ...) so the spec prefix tree's
    # treedef always matches the real graph's
    def nl_spec(fb):
        return replace(
            fb, start=P("sp"), nodes=P(), weights=P(),
            params=jax.tree.map(lambda _: P("sp"), fb.params)
            if fb.params is not None else None,
        )

    def lin_spec(lb):
        return replace(
            lb, start=P("sp"), lam=P("sp"), psi=P("sp"), target_mu=P("sp"),
            target_prec=P("sp"), constant=P("sp"),
        )

    return FactorGraph(
        num_states=graph.num_states, state_dim=graph.state_dim,
        nonlinear=tuple(nl_spec(fb) for fb in graph.nonlinear),
        linear=tuple(lin_spec(lb) for lb in graph.linear),
    )


def optimize_time_sharded(
    graph: FactorGraph,
    state: GaussianState,
    config: GVIConfig,
    mesh: Mesh,
    method: str = "ngd",
) -> tuple[GaussianState, GVIHistory]:
    """The FULL GVI loop with the trajectory axis sharded over mesh axis
    'sp' — identical semantics (and trajectories, up to psum reassociation)
    to ``optimize``.

    ``graph`` must be in chain layout (:func:`to_chain_layout`).
    """
    n, s = state.mu.shape
    p = mesh.shape["sp"]
    if n % p:
        raise ValueError(f"num_states {n} not divisible by sp={p}")
    off_pad = jnp.concatenate(
        [state.precision.off, jnp.zeros((1, s, s), state.mu.dtype)]
    )
    graph_spec = _chain_graph_specs(graph)
    state_spec = GaussianState(P("sp"), BlockTridiag(P("sp"), P("sp")))
    hist_spec = GVIHistory(
        mu=P(None, "sp"), cov_diag=P(None, "sp"), cov_off=P(None, "sp"),
        prec_diag=P(None, "sp"), prec_off=P(None, "sp"),
        cost=P(),
        factor_costs=tuple(
            P(None, "sp") for _ in graph.nonlinear + graph.linear
        ),
        accepted_step=P(),
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(graph_spec, state_spec),
        out_specs=(state_spec, hist_spec),
    )
    def run(graph_loc, state_loc):
        engine = TimeShardEngine(
            graph_loc, config, platform=resolve.mesh_platform(mesh)
        )
        return run_gvi(engine, state_loc, config, method)

    final, hist = jax.jit(run)(
        graph, GaussianState(state.mu, BlockTridiag(state.precision.diag,
                                                    off_pad))
    )
    # strip the padded (globally-last, always-zero) off-diagonal row
    final = GaussianState(
        final.mu,
        BlockTridiag(final.precision.diag, final.precision.off[:-1]),
    )
    hist = hist._replace(
        cov_off=hist.cov_off[:, :-1],
        prec_off=hist.prec_off[:, :-1],
        factor_costs=concat_factor_costs(
            hist.factor_costs, config.niters, state.mu.dtype
        ),
    )
    return final, hist


def sharded_time_ngd_step(graph: FactorGraph, state: GaussianState,
                          config, mesh: Mesh, temperature=1.0,
                          method: str = "ngd"):
    """One GVI step with the trajectory axis sharded over 'sp' at a fixed
    temperature (the multi-iteration loop is :func:`optimize_time_sharded`).

    ``graph`` must be in chain layout (:func:`to_chain_layout`).  Returns
    (GaussianState, cost_before_step).
    """
    cfg = replace(
        config,
        niters=1,
        temperature=float(temperature),
        niters_lowtemp=2**30,
        high_temperature=float(temperature),
    )
    final, hist = optimize_time_sharded(graph, state, cfg, mesh, method)
    return final, hist.cost[0]
