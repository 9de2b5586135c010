"""Backend engines for the unified GVI iteration loop.

One implementation of the GVI iteration — cost, gradients, natural-gradient
solve, backtracking line search, temperature schedule, EMA smoothing,
convergence freeze (:func:`.optimize.run_gvi`) — runs against this small
hook interface.  Three engines exist:

* :class:`LocalEngine` (here) — single device; used by
  :func:`.optimize.optimize`.
* ``FactorShardEngine`` (:mod:`..parallel.sharding`) — nonlinear factors
  sharded over the ``fp`` mesh axis, joint gradients assembled with ``psum``
  (the all-reduce replacing the reference's OpenMP critical section,
  ngd/NGD-GH-impl.h:33-51).
* ``TimeShardEngine`` (:mod:`..parallel.time_sharding`) — the trajectory
  axis sharded over ``sp``; chain recurrences via the sequence-parallel
  engine, edge factors via halo exchanges.

Engines are trace-time objects: constructed inside the jitted/shard_mapped
function, closing over the (traced) factor graph.  Per-factor expected
costs flow through the loop as a TUPLE of per-batch arrays (nonlinear
batches first, then linear) so sharded engines can psum exactly the sharded
entries and shard_map out_specs can reassemble each batch's axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import resolve
from ..factors import moments as mm
from ..ops.blocktridiag import BlockTridiag
from .graph import FactorGraph, gather_marginals


def vary_tree(tree, axes: tuple[str, ...]):
    """Mark every leaf as device-varying over ``axes`` (no-op for leaves
    already varying there).  Used to give loop-carry initializers the same
    variance type their updated values will have, so ``lax.scan`` /
    ``lax.while_loop`` carries type-check under ``shard_map``'s vma system
    (check_vma=True) instead of opting out of it."""
    if not axes:
        return tree

    def one(x):
        missing = tuple(
            a for a in axes
            if a not in getattr(jax.typeof(x), "vma", frozenset())
        )
        if not missing:
            return x
        return jax.lax.pcast(x, missing, to="varying")

    return jax.tree.map(one, tree)


class LocalEngine:
    """Single-device hooks: the whole graph lives on this device.

    ``platform`` names the device the engine's program compiles for (None:
    :func:`..resolve.target_platform`); "auto" implementation choices in
    ``config`` resolve against it (:mod:`..resolve`)."""

    # mesh axes over which loop-carried scalars become varying (none here)
    carry_axes: tuple[str, ...] = ()

    def __init__(self, graph: FactorGraph, config, platform: str | None = None):
        from .optimize import chain_ops

        self.graph = graph
        self.config = config
        platform = platform or resolve.target_platform()
        self.chain_impl = resolve.chain_impl(
            platform, config.chain_impl, graph.num_states, graph.state_dim,
            config.assoc_threshold,
            sharded=bool(self.carry_axes),  # mesh axes: under shard_map
        )
        self.sqrtm_method = resolve.sqrtm_method(platform, "auto")
        self._cov_fn, self._solve_fn = chain_ops(self.chain_impl)

    # -- chain ---------------------------------------------------------------
    def cov_logdet(self, prec: BlockTridiag):
        """(cov_diag, cov_off, logdet) of the joint precision."""
        return self._cov_fn(prec)

    # -- costs ---------------------------------------------------------------
    def factor_costs_raw(self, mu, cov_diag, cov_off, eval_dtype=None):
        """Untempered per-factor E[psi_k], one array per batch (nonlinear
        batches first, then linear — the order `reduce_fc` and recording
        rely on)."""
        g = self.graph
        out = []
        for fb in g.nonlinear:
            mu_k, cov_k = gather_marginals(
                fb.start, fb.nb, mu, cov_diag, cov_off, fb.slice_offset
            )
            out.append(mm.batch_phi(fb, mu_k, cov_k, eval_dtype))
        for lb in g.linear:
            out.append(mm.batch_linear_cost(lb, mu, cov_diag, cov_off))
        return tuple(out)

    def reduce_fc(self, fc_tuple):
        """Global sum of (already tempered) per-factor costs."""
        if not fc_tuple:
            return jnp.zeros(())
        return sum(jnp.sum(f) for f in fc_tuple)

    # -- gradients -----------------------------------------------------------
    def ngd_gradients(self, mu, cov_diag, cov_off, temperature,
                      eval_dtype=None):
        from .gvi import ngd_gradients

        return ngd_gradients(
            self.graph, mu, cov_diag, cov_off, temperature, eval_dtype
        )

    def prox_gradients(self, mu, cov_diag, cov_off, step_size):
        from .gvi import prox_gradients

        return prox_gradients(
            self.graph, mu, cov_diag, cov_off, step_size, self.sqrtm_method
        )

    # -- solve ---------------------------------------------------------------
    def solve_pair(self, bt_main: BlockTridiag, bt_fallback: BlockTridiag,
                   rhs):
        """Solve both systems (main metric + SPD fallback) against the same
        rhs [N, s]; ONE batched chain call so the chain kernel takes both."""
        flat = rhs.reshape(-1)
        sols = jax.vmap(lambda d, o: self._solve_fn(BlockTridiag(d, o), flat))(
            jnp.stack([bt_main.diag, bt_fallback.diag]),
            jnp.stack([bt_main.off, bt_fallback.off]),
        )
        return sols[0].reshape(rhs.shape), sols[1].reshape(rhs.shape)

    def all_finite(self, x) -> jnp.ndarray:
        """Globally-agreed scalar: is every element finite on every shard."""
        return jnp.isfinite(x).all()
