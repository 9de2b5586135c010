"""Factor-graph building blocks, batched per factor type.

Design translation (SURVEY.md section 7): where the reference instantiates
one virtual-dispatch optimizer object per factor, each owning a quadrature
instance and OpenMP-looping over the factor vector
(gvibase/GVIFactorizedBase.h:36-248, ngd/NGD-GH-impl.h:33-51), this design
groups all factors of one *type* (same cost function, same per-factor
dimension) into a single batch whose parameters carry a leading ``K`` axis.
Everything downstream is one ``vmap``/einsum over that axis.

A factor spans ``nb`` consecutive trajectory states of dimension ``s``
(``nb = 1`` for anchors/collision costs, ``nb = 2`` for GP priors between
neighbors — the reference's ``TrajectoryBlock`` mapping,
helpers/MatrixHelper.h:119-161); its local dim is ``d = nb * s``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..quadrature import get_rule


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NonlinearFactorBatch:
    """K same-type nonlinear factors integrated by sigma-point quadrature.

    ``cost_fn(x [d], params_k) -> scalar`` is the negative log potential
    ``psi_k``; ``params`` is a pytree whose leaves have a leading K axis
    (or None).  ``nodes``/``weights`` are the shared zero-mean quadrature
    rule (reference quadrature/SparseGaussHermite.h:138-166, loaded once and
    device-resident here).
    """

    start: jnp.ndarray          # [K] int32, first state index of the support
    nodes: jnp.ndarray          # [M, d] zero-mean sigma nodes
    weights: jnp.ndarray        # [M]
    params: Any                 # pytree, leading K axis on leaves
    cost_fn: Callable[..., jnp.ndarray] = field(metadata=dict(static=True))
    nb: int = field(metadata=dict(static=True), default=1)
    # when the supports are consecutive states (start == offset + arange(K)),
    # the joint gather/scatter lowers to static slices instead of XLA
    # gather/scatter ops; None = general
    slice_offset: int | None = field(metadata=dict(static=True), default=None)
    # contract: ``cost_fn >= 0`` everywhere (true for every reference cost —
    # squared residuals and hinge losses).  When set, a NEGATIVE sparse-GH
    # E[phi] estimate on the line-search cost path is poisoned to NaN
    # (trial rejected): the signed-weight sum of a nonnegative integrand
    # can only go negative through quadrature/rounding garbage — the
    # f32 accept-collapse class.  Leave False
    # for potentials that can be legitimately negative (e.g. double-well
    # log-densities in the sampler-validation harness).
    nonneg_cost: bool = field(metadata=dict(static=True), default=False)
    # MARGINAL quadrature (None = off): the cost depends only on the
    # LEADING ``quad_rdim`` dims of the local support (e.g. collision
    # costs read position, never velocity — reference analog: the factor's
    # own ``dimension``-dim subspace via Pk, gvibase/GVIFactorizedBase.h:63-70),
    # so ``nodes`` hold an r-dim rule ZERO-PADDED to d (see
    # :func:`marginal_rule`).  With Cholesky sigma placement the padded
    # nodes land the cost evaluations exactly on the position-marginal
    # sigma points, E[phi] and E[(x-mu)phi] assemble exactly (the Gaussian
    # conditional lift collapses onto the standard assembly — see
    # moments.gh_moments), and E[(x-mu)(x-mu)^T phi] needs one closed-form
    # correction term.  Cuts sigma points ~3.2-4.7x (rule(2,3) = 13 vs
    # rule(4,3) = 41; rule(2,4) = 29 vs rule(4,4) = 137).
    quad_rdim: int | None = field(metadata=dict(static=True), default=None)

    @property
    def num_factors(self) -> int:
        return self.start.shape[0]

    @property
    def dim(self) -> int:
        return self.nodes.shape[-1]


def make_nonlinear_batch(
    cost_fn: Callable[..., jnp.ndarray],
    start_indices,
    state_dim: int,
    nb: int = 1,
    params: Any = None,
    gh_degree: int = 10,
    kind: str = "sparse",
    nonneg_cost: bool = False,
    quad_rdim: int | None = None,
    dtype=None,
) -> NonlinearFactorBatch:
    """Build a NonlinearFactorBatch with a (dim, degree) quadrature rule.

    ``quad_rdim``: the cost reads only the leading ``quad_rdim`` dims of
    its support — build the configuration-MARGINAL rule instead (see
    :func:`marginal_rule` and :attr:`NonlinearFactorBatch.quad_rdim`)."""
    dim = nb * state_dim
    if quad_rdim is not None and quad_rdim < dim:
        nodes, weights = marginal_rule(dim, quad_rdim, gh_degree, kind)
    else:
        nodes, weights = get_rule(dim, gh_degree, kind)
        quad_rdim = None
    dtype = dtype or jnp.zeros(0).dtype
    start_np = np.asarray(start_indices, dtype=np.int32)
    return NonlinearFactorBatch(
        start=jnp.asarray(start_np),
        nodes=jnp.asarray(nodes, dtype),
        weights=jnp.asarray(weights, dtype),
        params=params,
        cost_fn=cost_fn,
        nb=nb,
        nonneg_cost=nonneg_cost,
        quad_rdim=quad_rdim,
        slice_offset=detect_slice_offset(start_np),
    )


def marginal_rule(state_dim: int, config_dim: int, gh_degree: int,
                  kind: str = "sparse"):
    """``config_dim``-dim quadrature rule ZERO-PADDED to ``state_dim``
    (see :attr:`NonlinearFactorBatch.quad_rdim`): costs reading only the
    leading configuration block of the state integrate over the
    configuration MARGINAL (the reference's factors integrate over their
    own ``dimension``-dim Pk subspace the same way,
    gvibase/GVIFactorizedBase.h:63-70) — ~3.2-4.7x fewer sigma points at
    the shipped shapes, with the skipped velocity-block moment mass
    restored exactly in closed form (moments.gh_moments rdim)."""
    nodes, weights = get_rule(config_dim, gh_degree, kind)
    nodes = np.asarray(nodes)
    pad = np.zeros((nodes.shape[0], state_dim - config_dim), nodes.dtype)
    return np.concatenate([nodes, pad], axis=1), weights


def detect_slice_offset(start_np) -> int | None:
    """offset such that start == offset + arange(K), else None.

    K == 1 batches deliberately return None: slice_offset is STATIC pytree
    metadata, and single-factor batches (anchors) are routinely concatenated
    across different state indices with ``jax.tree.map`` — a static offset
    would make their treedefs unequal.  A one-element gather is cheap.
    """
    start_np = np.asarray(start_np)
    if start_np.ndim != 1 or start_np.size < 2:
        return None
    o = int(start_np[0])
    if np.array_equal(start_np, o + np.arange(start_np.size)):
        return o
    return None


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LinearFactorBatch:
    """K closed-form linear-Gaussian factors.

    Negative log potential ``psi(x) = C * ||Lam x - Psi mu_t||^2_{prec_t}``
    (reference gp/linear_factor.h:18-31).  ``Lam``/``Psi`` map the local
    d-dimensional support to the r-dimensional residual.
    """

    start: jnp.ndarray          # [K] int32
    lam: jnp.ndarray            # [K, r, d]
    psi: jnp.ndarray            # [K, r, dt]
    target_mu: jnp.ndarray      # [K, dt]
    target_prec: jnp.ndarray    # [K, r, r]
    constant: jnp.ndarray       # [K]
    nb: int = field(metadata=dict(static=True), default=1)
    # see NonlinearFactorBatch.slice_offset
    slice_offset: int | None = field(metadata=dict(static=True), default=None)

    @property
    def num_factors(self) -> int:
        return self.start.shape[0]

    @property
    def dim(self) -> int:
        return self.lam.shape[-1]
