"""The GVI optimization loop: NGD and Wasserstein-proximal variants.

Reproduces the reference's loop semantics exactly (validated against the
committed data/1d and data/1d_proxgvi trajectories):

* record (mu, Sigma, Lambda, cost, per-factor costs) at the TOP of each
  iteration (gvibase/GVI-GH-impl.h:56-66);
* NGD backtracking: trial step = step_size_base * 0.75, then x0.75 per
  failure (GVI-GH-impl.h:76-86 — the pow(base, B) line is commented out
  upstream); Prox backtracking: trial step = base**B, B = 1, 2, ...
  (proxgd/ProxGVI-GH-impl.h:151-176), with the JKO pseudo-gradients computed
  once per iteration at step base**1;
* after niters_backtrack+1 failed trials: switch to the high temperature if
  still in the low phase, else flag convergence (GVI-GH-impl.h:100-115);
* scheduled switch to high temperature at iteration niters_lowtemp
  (GVI-GH-impl.h:45-51).

The whole run is one ``lax.scan`` over iterations with the line search
inside — a single XLA computation, no host round-trips (the reference's
CUDA path crosses the device boundary per trial, GVI-GH-Cuda-impl.h:150-286).
One divergence from the reference: upstream *breaks* the loop on
convergence, so its recorder holds fewer rows; here the carried state
freezes instead and subsequent recorded rows repeat it.

The loop body is written ONCE against the :mod:`.engine` hook interface
(:func:`run_gvi`); :func:`optimize` runs it on the single-device
:class:`.engine.LocalEngine`, while :mod:`..parallel.sharding` and
:mod:`..parallel.time_sharding` run the SAME body factor-sharded (psum
assembly) and time-sharded (sequence-parallel chain) respectively — so
temperature schedule, EMA smoothing, convergence freeze, and line-search
semantics are identical on every execution path.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.blocktridiag import (
    BlockTridiag,
    gbp_covariance_logdet,
    in_float64,
    solve,
)
from ..ops.parallel_chain import gbp_covariance_logdet_assoc, solve_assoc


def chain_ops(impl: str):
    """(cov_logdet, solve) single-problem chain functions for a resolved
    ``chain_impl`` (see :func:`..resolve.chain_impl`), computed in float64
    (:func:`..ops.blocktridiag.in_float64`: float32 data need 64-bit
    types)."""
    if impl == "kernel":
        from ..kernels.chain_block import (
            gbp_covariance_logdet_single,
            solve_single,
        )

        ops = gbp_covariance_logdet_single, solve_single
    elif impl == "assoc":
        ops = gbp_covariance_logdet_assoc, solve_assoc
    else:
        ops = gbp_covariance_logdet, solve
    return tuple(in_float64(op) for op in ops)


from .config import GVIConfig
from .engine import LocalEngine, vary_tree
from .graph import FactorGraph, GaussianState


class GVIHistory(NamedTuple):
    """Per-iteration records (the reference's VIMPResults,
    helpers/DataRecorder.h:96-118)."""

    mu: jnp.ndarray            # [niters, N, s]
    cov_diag: jnp.ndarray      # [niters, N, s, s]
    cov_off: jnp.ndarray       # [niters, N-1, s, s]
    prec_diag: jnp.ndarray     # [niters, N, s, s]
    prec_off: jnp.ndarray      # [niters, N-1, s, s]
    cost: jnp.ndarray          # [niters]
    factor_costs: jnp.ndarray  # [niters, K_total] (tuple of per-batch
                               # arrays inside run_gvi; concatenated by the
                               # public wrappers)
    accepted_step: jnp.ndarray  # [niters]


class LoopState(NamedTuple):
    """The loop-carried scalars beyond (mu, Lambda): everything needed to
    resume a run mid-trajectory exactly (SURVEY.md section 5.4 — the
    reference has no mid-run checkpointing; covariance/logdet/factor
    expectations are deterministically recomputable from the state and are
    rebuilt on resume by :func:`make_gvi_init`)."""

    temperature: jnp.ndarray
    is_lowtemp: jnp.ndarray
    converged: jnp.ndarray


class _Carry(NamedTuple):
    state: GaussianState
    # covariance + logdet of state.precision, carried so the accepted
    # line-search trial's chain computation is reused instead of redone at
    # the top of the next iteration (identical input -> identical result).
    cov_diag: jnp.ndarray
    cov_off: jnp.ndarray
    logdet: jnp.ndarray
    # untempered per-factor expected costs E[psi_k] at (mu, cov) — carried
    # for the same reason: the accepted trial already evaluated them, and
    # the temperature only ever enters as a division applied at use.
    # A TUPLE of per-batch arrays (see engine.py).
    fc_raw: tuple
    temperature: jnp.ndarray
    is_lowtemp: jnp.ndarray
    converged: jnp.ndarray


def make_gvi_step(engine, config: GVIConfig, method: str = "ngd"):
    """The GVI iteration body as a standalone ``(carry, i_iter) -> (carry,
    record)`` function (the ``lax.scan`` body of :func:`run_gvi`).

    Exposed so large shapes can run the loop from the host with the body
    jitted ONCE per iteration program instead of one whole-run program —
    the workaround for whole-program compile limits; :func:`run_gvi`
    itself scans this same body."""
    if method not in ("ngd", "prox"):
        raise ValueError(f"unknown method {method!r}")
    temper_costs = method == "ngd"
    eval_dtype = _eval_dtype(config, method)

    def temper(fc_raw, temperature):
        # elementwise division exactly as the cost path applies it, so the
        # carried-raw path is bitwise identical to recomputation
        if not temper_costs:
            return fc_raw
        return jax.tree.map(lambda f: f / temperature, fc_raw)

    def iteration(carry: _Carry, i_iter):
        (state, cov_diag, cov_off, logdet, fc_raw, temperature, is_lowtemp,
         converged) = carry
        dtype = state.mu.dtype

        # scheduled high-temperature switch (GVI-GH-impl.h:45-51)
        do_switch = jnp.logical_and(i_iter == config.niters_lowtemp, is_lowtemp)
        temperature = jnp.where(
            do_switch, jnp.asarray(config.high_temperature, dtype), temperature
        )
        is_lowtemp = jnp.logical_and(is_lowtemp, jnp.logical_not(do_switch))

        # covariance AND untempered factor expectations of the current
        # iterate are carried in — E[psi_k] does not depend on the
        # temperature (the switch above only changes the division below), so
        # no quadrature pass is needed at the top of the iteration
        fc_iter = temper(fc_raw, temperature)
        cost_iter = engine.reduce_fc(fc_iter) + 0.5 * logdet

        if method == "ngd":
            # trial schedule: base * 0.75^t, t = 1..niters_backtrack+1
            # (GVI-GH-impl.h:76-86; the pow(base, B) line is commented
            # out upstream)
            n_trials = config.niters_backtrack + 1
            trials = config.step_size_base * (
                config.step_decay ** jnp.arange(1, n_trials + 1, dtype=dtype)
            )
            vdmu, vddmu = engine.ngd_gradients(
                state.mu, cov_diag, cov_off, temperature, eval_dtype
            )
            dprec = vddmu - state.precision
            # Vddmu can be indefinite far from the optimum (negative factor
            # curvature, e.g. inside obstacles) and the Cholesky-based
            # Thomas solve then yields NaN; fall back to the current
            # precision as metric — always SPD, still a descent direction.
            # (The reference CG-solves the same indefinite system and relies
            # on backtracking to reject bad steps, ngd/NGD-GH-impl.h:57-62.)
            dmu, fallback = engine.solve_pair(vddmu, state.precision, -vdmu)
            dmu = jnp.where(engine.all_finite(dmu), dmu, fallback)
        else:
            grad_step = config.step_size_base  # pow(base, 1)
            dmu, dprec = engine.prox_gradients(
                state.mu, cov_diag, cov_off, grad_step
            )
            # trial schedule: base^B, B = 1..niters_backtrack+1
            # (proxgd/ProxGVI-GH-impl.h:151-176)
            n_trials = config.niters_backtrack + 1
            trials = jnp.asarray(config.step_size_base, dtype) ** jnp.arange(
                1, n_trials + 1, dtype=dtype
            )

        # ---- backtracking line search ----
        # Both strategies select the IDENTICAL iterate: the first trial of
        # the schedule whose cost decreases (the reference's sequential
        # shrink loop, GVI-GH-impl.h:76-118).
        #   "batched": all candidates in ONE vmapped cost computation — a
        #     single wide kernel instead of up to n_trials serialized evals;
        #   "seq": lax.while_loop stopping at the first accepted trial — at
        #     steady state the search accepts trial 1, so only ~1 chain op +
        #     quadrature runs instead of n_trials.
        # Trial covariances are returned so the accepted one can be carried
        # into the next iteration without recomputation.  Sharded engines
        # reduce each trial cost globally, so every device takes the same
        # branch and stays in lockstep.
        def trial_cost(s):
            new_mu = state.mu + s * dmu
            new_prec = (state.precision + dprec.scale(s)).symmetrize()
            t_cd, t_co, t_ld = engine.cov_logdet(new_prec)
            fc_raw_t = engine.factor_costs_raw(new_mu, t_cd, t_co, eval_dtype)
            cost = engine.reduce_fc(temper(fc_raw_t, temperature)) + 0.5 * t_ld
            return cost, t_cd, t_co, t_ld, fc_raw_t

        if config.linesearch == "seq":
            # do-while: trial 0 evaluated up front, loop stops at the first
            # decreasing trial (NaN costs compare False); converged problems
            # stop after one trip so a vmapped batch isn't held hostage by
            # frozen members
            c0, cd0, co0, ld0, fc0 = trial_cost(trials[0])
            init_ls = (
                jnp.asarray(1, jnp.int32), c0 < cost_iter,
                jnp.asarray(0, jnp.int32), c0, cd0, co0, ld0, fc0,
            )
            init_ls = vary_tree(init_ls, engine.carry_axes)

            def ls_cond(c):
                t, ok = c[0], c[1]
                return jnp.logical_and(
                    jnp.logical_and(t < n_trials, jnp.logical_not(ok)),
                    jnp.logical_not(converged),
                )

            def ls_body(c):
                t = c[0]
                ci, cdi, coi, ldi, fci = trial_cost(trials[t])
                return (t + 1, ci < cost_iter, t, ci, cdi, coi, ldi, fci)

            (_, accepted, sel, c_sel, cd_sel, co_sel, ld_sel, fc_sel) = (
                lax.while_loop(ls_cond, ls_body, init_ls)
            )
        elif config.linesearch == "batched":
            (trial_costs, trial_cds, trial_cos, trial_lds, trial_fcs) = (
                jax.vmap(trial_cost)(trials)
            )
            ok = trial_costs < cost_iter  # NaN costs compare False
            accepted = jnp.any(ok)
            # stop index: first decreasing trial, or the last trial when the
            # search is exhausted (matches where the sequential loop halts)
            sel = jnp.where(accepted, jnp.argmax(ok), n_trials - 1)
            c_sel = trial_costs[sel]
            cd_sel = trial_cds[sel]
            co_sel = trial_cos[sel]
            ld_sel = trial_lds[sel]
            fc_sel = jax.tree.map(lambda f: f[sel], trial_fcs)
        else:
            raise ValueError(f"unknown linesearch {config.linesearch!r}")
        # Prox accepts the LAST trial even when the search is exhausted
        # (proxgd/ProxGVI-GH-impl.h:186-192 calls update_proposal before
        # break); NGD keeps the old iterate (GVI-GH-impl.h:100-115).
        if method == "ngd":
            take = accepted
        else:
            # guard the exhausted-take against a non-finite proposal: the
            # reference's SPD checks (proxgd/ProxGVIFactorizedBaseGH.h:
            # 192-215) reject such covariances before they reach the update;
            # here the equivalent is refusing to adopt a NaN-cost iterate
            take = jnp.logical_or(accepted, jnp.isfinite(c_sel))
        step_f = trials[sel]
        # EMA-smoothed proposal (GVI-GH-Cuda-impl.h:112-114):
        # alpha * new + (1 - alpha) * current; alpha = 1 is plain.  The
        # accept decision above is made on the UNBLENDED trial cost, as in
        # the reference.
        alpha = config.ema_alpha
        acc_mu = jnp.where(take, state.mu + alpha * step_f * dmu, state.mu)
        sel_prec = (state.precision + dprec.scale(step_f)).symmetrize()
        if alpha != 1.0:
            sel_prec = BlockTridiag(
                alpha * sel_prec.diag + (1.0 - alpha) * state.precision.diag,
                alpha * sel_prec.off + (1.0 - alpha) * state.precision.off,
            )
        acc_prec = BlockTridiag(
            jnp.where(take, sel_prec.diag, state.precision.diag),
            jnp.where(take, sel_prec.off, state.precision.off),
        )

        # exhausted line search: escalate temperature once, then converge
        # (GVI-GH-impl.h:100-115; NGD only — prox neither escalates nor
        # flags convergence, proxgd/ProxGVI-GH-impl.h:125-205)
        failed = (
            jnp.logical_not(accepted)
            if method == "ngd"
            else jnp.zeros((), bool)
        )
        esc_temp = jnp.logical_and(failed, is_lowtemp)
        new_temperature = jnp.where(
            esc_temp, jnp.asarray(config.high_temperature, dtype), temperature
        )
        new_is_lowtemp = jnp.logical_and(is_lowtemp, jnp.logical_not(esc_temp))
        new_converged = jnp.logical_or(
            converged, jnp.logical_and(failed, jnp.logical_not(is_lowtemp))
        )

        # freeze the state once converged (reference breaks out instead)
        keep = jnp.logical_not(converged)
        new_state = GaussianState(
            jnp.where(keep, acc_mu, state.mu),
            BlockTridiag(
                jnp.where(keep, acc_prec.diag, state.precision.diag),
                jnp.where(keep, acc_prec.off, state.precision.off)
                if state.precision.off.size else state.precision.off,
            ),
        )
        if alpha != 1.0:
            # the blended (mu, precision) differ from the evaluated trial;
            # covariance and factor expectations must be computed fresh (one
            # extra chain call + quadrature pass, only with EMA smoothing)
            new_cov_diag, new_cov_off, new_logdet = engine.cov_logdet(
                new_state.precision
            )
            new_fc_raw = engine.factor_costs_raw(
                new_state.mu, new_cov_diag, new_cov_off, eval_dtype
            )
        else:
            # carry the accepted trial's covariance + factor expectations
            # forward (bitwise what the next iteration would recompute)
            upd = jnp.logical_and(keep, take)
            new_cov_diag = jnp.where(upd, cd_sel, cov_diag)
            new_cov_off = (
                jnp.where(upd, co_sel, cov_off)
                if cov_off.size else cov_off
            )
            new_logdet = jnp.where(upd, ld_sel, logdet)
            new_fc_raw = jax.tree.map(
                lambda a, b: jnp.where(upd, a, b), fc_sel, fc_raw
            )
        record = (
            state.mu, cov_diag, cov_off,
            state.precision.diag, state.precision.off,
            cost_iter, fc_iter,
            jnp.where(accepted, step_f, jnp.zeros((), dtype)),
        )
        new_carry = _Carry(
            new_state, new_cov_diag, new_cov_off, new_logdet, new_fc_raw,
            new_temperature, new_is_lowtemp, new_converged,
        )
        return new_carry, record

    return iteration


def _eval_dtype(config: GVIConfig, method: str):
    return (
        jnp.dtype(config.moments_eval_dtype)
        if config.moments_eval_dtype and method == "ngd" else None
    )


def make_gvi_init(
    engine, init_state: GaussianState, config: GVIConfig,
    method: str = "ngd", loop: LoopState | None = None,
) -> _Carry:
    """The initial loop carry for :func:`make_gvi_step`'s body (covariance
    + logdet + untempered factor expectations of the initial iterate).

    ``loop`` overrides the fresh-start loop scalars — pass a checkpointed
    :class:`LoopState` to resume mid-run: the chain/quadrature fields are
    recomputed here from (mu, Lambda), which reproduces the uninterrupted
    carry exactly (same function of the same inputs)."""
    dtype = init_state.mu.dtype
    cov_diag0, cov_off0, ld0 = engine.cov_logdet(init_state.precision)
    fc_raw0 = engine.factor_costs_raw(
        init_state.mu, cov_diag0, cov_off0, _eval_dtype(config, method)
    )
    if loop is None:
        loop = LoopState(
            jnp.asarray(config.temperature, dtype),
            jnp.ones((), bool),
            jnp.zeros((), bool),
        )
    init_carry = _Carry(
        init_state,
        cov_diag0,
        cov_off0,
        ld0,
        fc_raw0,
        jnp.asarray(loop.temperature, dtype),
        jnp.asarray(loop.is_lowtemp, bool),
        jnp.asarray(loop.converged, bool),
    )
    # carry initializers must already have the variance type their updated
    # values will acquire (e.g. temperature becomes dp-varying after one
    # data-dependent escalation decision) for the scan to type-check under
    # shard_map's vma system
    return vary_tree(init_carry, engine.carry_axes)


def run_gvi_carry(
    engine,
    init_state: GaussianState,
    config: GVIConfig,
    method: str = "ngd",
    start_iteration: int = 0,
    loop: LoopState | None = None,
) -> tuple[_Carry, GVIHistory]:
    """:func:`run_gvi` returning the FULL final carry (trace-time).

    ``start_iteration``/``loop`` resume a checkpointed run: the scan covers
    iterations ``start_iteration..niters-1`` (so the scheduled
    ``niters_lowtemp`` temperature switch lands on the same global
    iteration index as the uninterrupted run) and the loop scalars start
    from the checkpointed :class:`LoopState`.
    """
    iteration = make_gvi_step(engine, config, method)
    init_carry = make_gvi_init(engine, init_state, config, method, loop)
    final_carry, records = lax.scan(
        iteration, init_carry, jnp.arange(start_iteration, config.niters)
    )
    history = GVIHistory(*records)
    return final_carry, history


def run_gvi(
    engine,
    init_state: GaussianState,
    config: GVIConfig,
    method: str = "ngd",
) -> tuple[GaussianState, GVIHistory]:
    """The unified GVI loop over an engine (trace-time; call under jit).

    Returns the final state and history; ``history.factor_costs`` is the
    raw tuple of per-batch cost arrays (callers concatenate/reassemble).
    """
    final_carry, history = run_gvi_carry(engine, init_state, config, method)
    return final_carry.state, history


def concat_factor_costs(fc, niters: int, dtype) -> jnp.ndarray:
    """Flatten the per-batch cost tuple into the reference's [T, K_total]."""
    fc_leaves = jax.tree.leaves(fc)
    if not fc_leaves:
        return jnp.zeros((niters, 0), dtype)
    return jnp.concatenate(fc_leaves, axis=-1)


@partial(jax.jit, static_argnames=("config", "method"))
def optimize(
    graph: FactorGraph,
    init_state: GaussianState,
    config: GVIConfig = GVIConfig(),
    method: str = "ngd",
) -> tuple[GaussianState, GVIHistory]:
    """Run the full GVI loop; returns the final state and iteration history."""
    engine = LocalEngine(graph, config)
    state, history = run_gvi(engine, init_state, config, method)
    return state, history._replace(
        factor_costs=concat_factor_costs(
            history.factor_costs, config.niters, init_state.mu.dtype
        )
    )


@partial(jax.jit, static_argnames=("config", "method", "start_iteration"))
def optimize_from(
    graph: FactorGraph,
    init_state: GaussianState,
    config: GVIConfig = GVIConfig(),
    method: str = "ngd",
    start_iteration: int = 0,
    loop_state: LoopState | None = None,
) -> tuple[GaussianState, GVIHistory, LoopState]:
    """:func:`optimize` with full checkpoint/resume semantics.

    Runs iterations ``start_iteration..niters-1`` starting from
    ``loop_state`` (None = fresh start) and additionally returns the final
    :class:`LoopState` — (temperature, is_lowtemp, converged) — which,
    together with the returned ``GaussianState`` and the iteration index,
    is the COMPLETE loop state: a run checkpointed mid-trajectory (even
    across a temperature escalation or a convergence freeze) and resumed
    here reproduces the uninterrupted trajectory exactly
    (tests/test_resume.py).  History rows cover the resumed window only.
    """
    engine = LocalEngine(graph, config)
    carry, history = run_gvi_carry(
        engine, init_state, config, method, start_iteration, loop_state
    )
    final_loop = LoopState(carry.temperature, carry.is_lowtemp,
                           carry.converged)
    return carry.state, history._replace(
        factor_costs=concat_factor_costs(
            history.factor_costs, config.niters - start_iteration,
            init_state.mu.dtype,
        )
    ), final_loop
