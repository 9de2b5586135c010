"""Per-iteration communication accounting for the sharded engines.

SURVEY.md section 5.8 / BASELINE.md set a >=0.8 factor-parallel scaling
target.  Beside the virtual-mesh scaling log (SCALING.md) and the compiled
multi-device runs, THIS module is an analytic model of every collective an
iteration issues — what crosses devices, how many bytes, against how many
on-device FLOPs — VERIFIED against the actually-traced program (the test
walks the jaxpr of ``optimize_sharded`` and asserts the traced collective
inventory equals the model's prediction, tests/test_comm_model.py).

The factor-parallel step's communication (the all-reduce replacing the
reference's OpenMP critical section, ngd/NGD-GH-impl.h:33-51) is tiny and
N-proportional while compute is N*K*M-proportional — the analytic ratio is
what supports the >=0.8 efficiency expectation at pod scale.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import jax
import numpy as np
from jax.extend.core import ClosedJaxpr, Jaxpr

_COLLECTIVES = (
    "psum", "all_gather", "ppermute", "all_to_all", "reduce_scatter",
)


def collective_inventory(fn, *args) -> Counter:
    """Trace ``fn(*args)`` and return a Counter of
    (primitive, input shapes, axes) over every collective in the program,
    descending through jit/shard_map/scan/while bodies."""

    jaxpr = jax.make_jaxpr(fn)(*args)

    def sub(v):
        if isinstance(v, ClosedJaxpr):
            return [v.jaxpr]
        if isinstance(v, Jaxpr):
            return [v]
        if isinstance(v, (list, tuple)):
            out = []
            for vv in v:
                out += sub(vv)
            return out
        return []

    coll: Counter = Counter()

    def walk(jx):
        for eqn in jx.eqns:
            name = eqn.primitive.name
            if any(k in name for k in _COLLECTIVES):
                shapes = tuple(
                    tuple(getattr(o.aval, "shape", ())) for o in eqn.invars
                )
                ax = eqn.params.get("axes", eqn.params.get("axis_name", ""))
                coll[(name, shapes, str(ax))] += 1
            for v in eqn.params.values():
                for j in sub(v):
                    walk(j)

    walk(jaxpr.jaxpr)
    return coll


@dataclass(frozen=True)
class CommReport:
    bytes_per_iter: int        # collective payload bytes over the fp axis
    flops_per_iter: int        # approximate on-chip FLOPs per problem-iter
    collectives: tuple         # ((name, shape, axis), count) entries

    @property
    def flops_per_byte(self) -> float:
        return self.flops_per_iter / max(self.bytes_per_iter, 1)


def factor_shard_model(n: int, s: int, n_trials: int, m_nodes: int,
                       k_nl: int, local_batch: int = 1,
                       itemsize: int = 8) -> tuple[Counter, CommReport]:
    """Predicted collective inventory of ONE ``optimize_sharded`` NGD
    iteration (FactorShardEngine, batched linesearch, fused kernels off —
    the sharded configuration).

    Per iteration, per local problem:
      * gradient assembly: psum of Vdmu [N, s], Vddmu diag [N, s, s] and
        off [N-1, s, s] over fp (inference: sharding.FactorShardEngine.
        ngd_gradients);
      * line search: ONE [T] psum of the vmapped trial costs
        (engine.reduce_fc inside the vmap over trials);
      * top-of-iteration cost: one scalar psum.
    """
    b = local_batch
    expected = Counter({
        ("psum_invariant", (((b,),)), "('fp',)"): 1,
        ("psum_invariant", (((b, n, s),)), "('fp',)"): 1,
        ("psum_invariant", (((b, n, s, s),)), "('fp',)"): 1,
        ("psum_invariant", (((b, n_trials),)), "('fp',)"): 1,
    })
    # the vddmu off-diag psum loses the unit vmap dim when b == 1 (batching
    # rule collapses it); match what the tracer emits
    off_shape = (n - 1, s, s) if b == 1 else (b, n - 1, s, s)
    expected[("psum_invariant", ((off_shape,)), "('fp',)")] += 1

    payload = b * (1 + n * s + n * s * s + n_trials) + int(
        np.prod(off_shape)
    )
    # per-problem FLOP model (order-of-magnitude; dominated by quadrature):
    #   quadrature: (1 + n_trials) cost passes + 1 moment pass over K
    #   factors x M nodes x ~(s^2 sigma placement + ~20 cost flops)
    #   chain: (1 + n_trials) sweeps x N x ~14 s^3 (chol + solves + edge inv)
    quad = (2 + n_trials) * k_nl * m_nodes * (s * s + 20)
    chain = (1 + n_trials) * n * 14 * s ** 3
    report = CommReport(
        bytes_per_iter=payload * itemsize,
        flops_per_iter=int(b * (quad + chain)),
        collectives=tuple(sorted(expected.items())),
    )
    return expected, report


def time_shard_model(n: int, s: int, n_trials: int, mesh,
                     dtype=None) -> Counter:
    """Predicted collective inventory of ONE ``optimize_time_sharded`` NGD
    iteration (TimeShardEngine, batched linesearch, one nonlinear batch +
    one nb==2 linear batch in chain layout — the chain-estimation
    configuration).

    Composed per TRACE SITE (the inventory counts sites, not executions —
    see tests/test_comm_model.py): the sequence-parallel chain engine's
    collectives are traced in isolation (plain for the init/gradient
    sites, T-vmapped for the line-search trial site) and combined with
    the hand-counted halo/psum sites of the engine itself:

      * init: one chain covariance + the nb2 cost halos
        (_edge_marginals: 2 ppermutes — mu [s] and cov_diag [s, s]);
      * per iteration: cost psum (scalar), gradient halos
        (_edge_marginals 2 + _scatter_edge 2 ppermutes), TWO seqpar
        solves, the all_finite psum, the T-vmapped trial chain + trial
        cost halos + the [T] trial-cost psum.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from .chain_seqpar import (
        gbp_covariance_logdet_seqpar,
        solve_seqpar,
    )

    dtype = dtype or jnp.zeros(0).dtype
    diag = jnp.zeros((n, s, s), dtype)
    off = jnp.zeros((n, s, s), dtype)
    rhs = jnp.zeros((n, s), dtype)

    def _inv(fn, *args, specs, out_specs):
        run = jax.shard_map(
            fn, mesh=mesh, in_specs=specs, out_specs=out_specs
        )
        return collective_inventory(run, *args)

    inv_cov = _inv(
        lambda d, o: gbp_covariance_logdet_seqpar(d, o, "sp"),
        diag, off, specs=(P("sp"), P("sp")),
        out_specs=(P("sp"), P("sp"), P()),
    )
    diag_t = jnp.zeros((n_trials, n, s, s), dtype)
    off_t = jnp.zeros((n_trials, n, s, s), dtype)
    inv_cov_t = _inv(
        lambda d, o: jax.vmap(
            lambda dd, oo: gbp_covariance_logdet_seqpar(dd, oo, "sp")
        )(d, o),
        diag_t, off_t, specs=(P(None, "sp"), P(None, "sp")),
        out_specs=(P(None, "sp"), P(None, "sp"), P()),
    )
    inv_solve = _inv(
        lambda d, o, b: solve_seqpar(d, o, b, "sp"),
        diag, off, rhs, specs=(P("sp"), P("sp"), P("sp")),
        out_specs=P("sp"),
    )

    expected = Counter()
    expected += inv_cov                      # init covariance
    expected += inv_cov_t                    # T-vmapped trial covariances
    expected += inv_solve + inv_solve        # solve_pair (main + fallback)
    ax = "('sp',)"
    # halo ppermutes: _edge_marginals (mu [s], cd [s, s]) at the init cost
    # site, the gradient site, and the T-vmapped trial cost site;
    # _scatter_edge (vd [s], vdd [s, s]) at the gradient site
    for shape in ((s,), (s, s)):
        expected[("ppermute", ((shape,)), ax)] += 3   # init+grad+scatter
        expected[("ppermute", (((n_trials,) + shape,)), ax)] += 1  # trials
    # psums: cost_iter (scalar) + all_finite (scalar count), trial
    # costs [T] — all psum_invariant under the vma type system
    expected[("psum_invariant", (((),)), ax)] += 2
    expected[("psum_invariant", (((n_trials,),)), ax)] += 1
    return expected


def print_report(tag: str, rep: CommReport):
    print(f"[{tag}] collective bytes/iter = {rep.bytes_per_iter}  "
          f"~flops/iter = {rep.flops_per_iter:.3g}  "
          f"flops-per-collective-byte = {rep.flops_per_byte:.0f}")
    for (name, shapes, ax), ct in rep.collectives:
        print(f"    {ct}x {name} {shapes} over {ax}")
