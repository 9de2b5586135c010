"""Multi-device SPMD execution over a (dp, fp) device mesh.

The reference is single-process: its only parallelism is OpenMP over factors
with thread-private gradient accumulators reduced in a critical section
(ngd/NGD-GH-impl.h:33-51) and a single-GPU batched quadrature offload
(GVI-GH-Cuda-impl.h:150-286).  Here (SURVEY.md section 5.8):

* ``dp`` — data parallel over independent problems (parallel restarts /
  batched trajectories).
* ``fp`` — factor parallel: each device evaluates sigma-point moments for
  its shard of the nonlinear factors and the joint (Vdmu, Vddmu) is
  assembled with one ``psum`` over fp — the all-reduce that replaces the
  OMP critical section.

The iteration body is THE SAME code as the single-device path
(:func:`..inference.optimize.run_gvi`), driven through
:class:`FactorShardEngine` — so the full reference loop semantics
(temperature schedule, EMA smoothing, convergence freeze, backtracking on
the globally psum-reduced cost so every device stays in lockstep) hold
sharded, and :func:`optimize_sharded` trajectories match ``optimize()``
exactly (up to psum reassociation).
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
from ..inference.engine import LocalEngine
from ..inference.graph import (
    FactorGraph,
    GaussianState,
    gather_marginals,
    scatter_gradients,
)
from ..inference.optimize import GVIHistory, concat_factor_costs, run_gvi
from ..ops.blocktridiag import BlockTridiag


def make_mesh(dp: int, fp: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if dp * fp > len(devices):
        raise ValueError(
            f"mesh {dp}x{fp} needs {dp * fp} devices, have {len(devices)}"
        )
    dev_array = np.asarray(devices[: dp * fp]).reshape(dp, fp)
    return Mesh(dev_array, ("dp", "fp"))


def stack_problems(graphs: list[FactorGraph], states: list[GaussianState]):
    """Stack B same-structure problems along a new leading axis (on the
    host: one transfer per leaf, not one device op per problem)."""
    graphs = _align_slice_offsets(graphs)

    def stack(*xs):
        return jnp.asarray(np.stack([np.asarray(x) for x in xs]))

    return jax.tree.map(stack, *graphs), jax.tree.map(stack, *states)


def _align_slice_offsets(graphs: list[FactorGraph]) -> list[FactorGraph]:
    """Problems whose factor supports start at different states (e.g.
    anchors at different indices) can't stack with the static
    ``slice_offset`` set — fall those batches back to the general
    gather/scatter path."""
    out = list(graphs)
    for attr in ("nonlinear", "linear"):
        groups = [getattr(g, attr) for g in out]
        for k in range(min(len(t) for t in groups) if groups else 0):
            if len({t[k].slice_offset for t in groups}) > 1:
                out = [
                    replace(g, **{attr: tuple(
                        replace(fb, slice_offset=None) if i == k else fb
                        for i, fb in enumerate(getattr(g, attr))
                    )})
                    for g in out
                ]
    return out


def _null_nonlinear_slice_offsets(graph: FactorGraph) -> FactorGraph:
    """Drop slice_offset from fp-sharded nonlinear batches (static metadata
    that is only valid for the unsharded global K axis)."""
    return replace(graph, nonlinear=tuple(
        replace(fb, slice_offset=None) if fb.slice_offset is not None else fb
        for fb in graph.nonlinear
    ))


def _graph_specs(graph: FactorGraph, batched: bool):
    """PartitionSpec tree for a (batched) FactorGraph: nonlinear factor
    axes sharded over fp, problem axis over dp, rules replicated."""
    dp = ("dp",) if batched else ()

    # dataclasses.replace keeps ALL static metadata (nb, cost fns,
    # slice_offset, ...) so the spec prefix tree's
    # treedef always matches the real graph's
    def nl_spec(fb):
        return replace(
            fb,
            start=P(*dp, "fp"),
            nodes=P(*dp),
            weights=P(*dp),
            params=jax.tree.map(lambda _: P(*dp, "fp"), fb.params),
        )

    def lin_spec(lb):
        return replace(
            lb,
            start=P(*dp),
            lam=P(*dp),
            psi=P(*dp),
            target_mu=P(*dp),
            target_prec=P(*dp),
            constant=P(*dp),
        )

    return FactorGraph(
        num_states=graph.num_states,
        state_dim=graph.state_dim,
        nonlinear=tuple(nl_spec(fb) for fb in graph.nonlinear),
        linear=tuple(lin_spec(lb) for lb in graph.linear),
    )


def _state_spec(batched: bool):
    dp = ("dp",) if batched else ()
    return GaussianState(P(*dp), BlockTridiag(P(*dp), P(*dp)))


def _history_spec(graph: FactorGraph) -> GVIHistory:
    """out_specs for a run_gvi history under vmap-over-local-problems:
    problem axis over dp; nonlinear per-factor costs reassemble their
    (sharded) K axis over fp, linear costs are fp-replicated."""
    return GVIHistory(
        mu=P("dp"), cov_diag=P("dp"), cov_off=P("dp"),
        prec_diag=P("dp"), prec_off=P("dp"),
        cost=P("dp"),
        factor_costs=(
            tuple(P("dp", None, "fp") for _ in graph.nonlinear)
            + tuple(P("dp") for _ in graph.linear)
        ),
        accepted_step=P("dp"),
    )


class FactorShardEngine(LocalEngine):
    """Engine hooks with the nonlinear-factor axis sharded over ``fp``.

    The chain (covariance/log-det/solve) and the closed-form linear factors
    are cheap and replicated within each fp group — only the quadrature hot
    loop is sharded; the joint (Vdmu, Vddmu) and the total nonlinear cost
    are assembled with one ``psum`` over fp.  Loop-carried scalars become
    dp-varying after the first data-dependent decision (``carry_axes``).
    """

    carry_axes = ("dp",)

    def __init__(self, graph: FactorGraph, config, axis: str = "fp",
                 platform: str | None = None):
        self.axis = axis
        super().__init__(graph, config, platform)

    def reduce_fc(self, fc_tuple):
        n_nl = len(self.graph.nonlinear)
        nl, lin = fc_tuple[:n_nl], fc_tuple[n_nl:]
        # the costs' own dtype: a default-dtype zero would promote float32
        # costs to float64 under jax_enable_x64 and move the line search's
        # accept decisions away from the single-device run's
        total = jnp.zeros((), jnp.result_type(*fc_tuple))
        if nl:
            total = total + lax.psum(sum(jnp.sum(f) for f in nl), self.axis)
        if lin:
            # linear factors are replicated within the fp group — no psum
            total = total + sum(jnp.sum(f) for f in lin)
        return total

    def ngd_gradients(self, mu, cov_diag, cov_off, temperature,
                      eval_dtype=None):
        n, s = mu.shape
        vdmu = jnp.zeros_like(mu)
        vddmu = BlockTridiag.zeros(n, s, mu.dtype)
        for fb in self.graph.nonlinear:
            mu_k, cov_k = gather_marginals(
                fb.start, fb.nb, mu, cov_diag, cov_off
            )
            e_phi, e_xmu, e_xxt = mm.batch_moments(fb, mu_k, cov_k, eval_dtype)
            vd, vdd = mm.ngd_local_gradients(
                e_phi, e_xmu, e_xxt, cov_k, temperature
            )
            vdmu, vddmu = scatter_gradients(fb.start, fb.nb, vd, vdd, vdmu, vddmu)
        vdmu = lax.psum(vdmu, self.axis)
        vddmu = BlockTridiag(
            lax.psum(vddmu.diag, self.axis), lax.psum(vddmu.off, self.axis)
        )
        for lb in self.graph.linear:
            mu_k, _ = gather_marginals(lb.start, lb.nb, mu, cov_diag, cov_off)
            vd, vdd = mm.linear_local_gradients(
                lb.lam, lb.psi, lb.target_mu, lb.target_prec, lb.constant,
                mu_k, temperature,
            )
            vdmu, vddmu = scatter_gradients(lb.start, lb.nb, vd, vdd, vdmu, vddmu)
        return vdmu, vddmu

    def prox_gradients(self, mu, cov_diag, cov_off, step_size):
        from ..inference.gvi import prox_gradients

        nl_graph = replace(self.graph, linear=())
        lin_graph = replace(self.graph, nonlinear=())
        dmu_nl, dprec_nl = prox_gradients(
            nl_graph, mu, cov_diag, cov_off, step_size, self.sqrtm_method
        )
        dmu = lax.psum(dmu_nl, self.axis)
        dprec = BlockTridiag(
            lax.psum(dprec_nl.diag, self.axis),
            lax.psum(dprec_nl.off, self.axis),
        )
        dmu_l, dprec_l = prox_gradients(
            lin_graph, mu, cov_diag, cov_off, step_size, self.sqrtm_method
        )
        return dmu + dmu_l, dprec + dprec_l


def optimize_sharded(
    graph_b,
    state_b,
    config: GVIConfig,
    mesh: Mesh,
    method: str = "ngd",
) -> tuple[GaussianState, GVIHistory]:
    """The FULL GVI loop (identical semantics to ``optimize``), SPMD over
    (dp, fp).

    ``graph_b``/``state_b`` carry a leading problem axis (sharded over dp);
    each nonlinear batch's K axis is sharded over fp.  Returns the batched
    final state and per-problem history — trajectories match a vmapped
    ``optimize`` run up to floating-point reassociation of the psum.

    "auto" impls resolve against the MESH's platform
    (:func:`..resolve.mesh_platform`), with the chain on the scans
    (:func:`..resolve.chain_impl`, ``sharded``).
    """
    platform = resolve.mesh_platform(mesh)
    graph_spec = _graph_specs(graph_b, batched=True)
    state_spec = _state_spec(batched=True)
    hist_spec = _history_spec(graph_b)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(graph_spec, state_spec),
        out_specs=(state_spec, hist_spec),
    )
    def run(graph_loc, state_loc):
        # the factor K axis is sharded over fp, so a shard's local `start`
        # no longer satisfies start == slice_offset + arange(K_local) for
        # shards > 0: null the now-wrong static metadata
        graph_loc = _null_nonlinear_slice_offsets(graph_loc)

        def one(graph_i, state_i):
            engine = FactorShardEngine(graph_i, config, platform=platform)
            return run_gvi(engine, state_i, config, method)

        return jax.vmap(one)(graph_loc, state_loc)

    state, hist = jax.jit(run)(graph_b, state_b)
    return state, hist._replace(
        factor_costs=concat_factor_costs(
            hist.factor_costs, config.niters, state.mu.dtype
        )
    )


def sharded_ngd_step(graph_b, state_b, config, mesh: Mesh, temperature=1.0,
                     method: str = "ngd"):
    """One NGD/prox step, SPMD over (dp, fp), at a fixed temperature.

    Kept as the single-step entry point (the multi-iteration loop is
    :func:`optimize_sharded`).  Returns the updated batched state and the
    per-problem cost at the top of the step.
    """
    cfg = replace(
        config,
        niters=1,
        temperature=float(temperature),
        # a single fixed-temperature step: no scheduled switch, and an
        # exhausted line search must not change the temperature
        niters_lowtemp=2**30,
        high_temperature=float(temperature),
    )
    state, hist = optimize_sharded(graph_b, state_b, cfg, mesh, method)
    return state, hist.cost[:, 0]
