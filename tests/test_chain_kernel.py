"""Pallas chain kernel (kernels/chain_block.py) in interpret mode vs dense
float64 oracles, its padding, its vmap flattening and the engine wiring.

The kernel compiles only for the GPU; here it runs in Pallas interpret
mode.  ``block`` is kept small so the batches below are not multiples of
it and exercise the identity padding rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussianvi_tpu.kernels import chain_block as kb
from gaussianvi_tpu.ops.blocktridiag import (
    BlockTridiag,
    gbp_covariance_logdet,
    solve,
)
from gaussianvi_tpu.ops.chain_oracle import dense_oracle
from gaussianvi_tpu.ops.chain_oracle import random_chain as random_batch


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 5, 20, 32])
def test_matches_dense(n, s):
    """Covariance blocks, off-diagonal blocks, logdet and the solve vs the
    dense f64 inverse; B = 5 over blocks of 4 (one padded block)."""
    diag, off, rhs = random_batch(5, n, s, seed=10 * n + s)
    cd, co, ld = kb.gbp_covariance_logdet_kernel(
        jnp.asarray(diag), jnp.asarray(off), block=4, interpret=True
    )
    x = kb.solve_kernel(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(rhs), block=4,
        interpret=True,
    )
    rcd, rco, rld, rx = dense_oracle(diag, off, rhs)
    assert cd.shape == rcd.shape and co.shape == rco.shape
    np.testing.assert_allclose(cd, rcd, atol=1e-12)
    np.testing.assert_allclose(co, rco, atol=1e-12)
    np.testing.assert_allclose(ld, rld, rtol=1e-12)
    np.testing.assert_allclose(x, rx, atol=1e-12)


def test_padding_rows_are_identity_systems():
    diag, off, rhs = random_batch(3, 4, 2, seed=1)
    pd, po, pr = kb._pad_batch(
        jnp.asarray(diag), jnp.asarray(off), 4, jnp.asarray(rhs)
    )
    assert pd.shape == (4, 4, 2, 2) and po.shape == (4, 3, 2, 2)
    np.testing.assert_array_equal(pd[3], np.broadcast_to(np.eye(2), (4, 2, 2)))
    np.testing.assert_array_equal(po[3], 0.0)
    np.testing.assert_array_equal(pr[3], 0.0)
    np.testing.assert_array_equal(pd[:3], diag)


@pytest.mark.parametrize("block", [1, 2, 8])
def test_block_size_does_not_change_results(block):
    diag, off, rhs = random_batch(6, 5, 3, seed=2)
    ref = kb.gbp_covariance_logdet_kernel(
        jnp.asarray(diag), jnp.asarray(off), block=4, interpret=True
    )
    got = kb.gbp_covariance_logdet_kernel(
        jnp.asarray(diag), jnp.asarray(off), block=block, interpret=True
    )
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)


def test_pivot_trust_poisons_only_the_bad_problem():
    """A 2-state chain whose Schur pivot cancels to ~2 ulp gets a NaN
    logdet; its healthy neighbours in the same block do not."""
    diag, off, _ = random_batch(3, 2, 1, seed=3)
    diag[1] = [[[1.0]], [[1.0 + 4e-16]]]
    off[1] = [[[1.0]]]
    *_, ld = kb.gbp_covariance_logdet_kernel(
        jnp.asarray(diag), jnp.asarray(off), block=4, interpret=True
    )
    assert np.isnan(float(ld[1]))
    assert np.isfinite(np.asarray(ld)[[0, 2]]).all()


def _nested(n, s, seed):
    """[2 problems, 3 trials] of systems, as the line search nests them."""
    diag, off, rhs = random_batch(6, n, s, seed=seed)
    shape = (2, 3)
    return (jnp.asarray(diag).reshape(shape + diag.shape[1:]),
            jnp.asarray(off).reshape(shape + off.shape[1:]),
            jnp.asarray(rhs).reshape(shape + (n * s,)))


def test_nested_vmap_flattens_cov(monkeypatch):
    monkeypatch.setattr(
        kb, "gbp_covariance_logdet_kernel",
        _interpret(kb.gbp_covariance_logdet_kernel),
    )
    diag, off, _ = _nested(4, 3, seed=4)
    one = lambda d, o: kb.gbp_covariance_logdet_single(BlockTridiag(d, o))
    cd, co, ld = jax.vmap(jax.vmap(one))(diag, off)
    rcd, rco, rld = jax.vmap(jax.vmap(
        lambda d, o: gbp_covariance_logdet(BlockTridiag(d, o))))(diag, off)
    np.testing.assert_allclose(cd, rcd, atol=1e-12)
    np.testing.assert_allclose(co, rco, atol=1e-12)
    np.testing.assert_allclose(ld, rld, rtol=1e-12)


def test_nested_vmap_flattens_solve(monkeypatch):
    monkeypatch.setattr(kb, "solve_kernel", _interpret(kb.solve_kernel))
    diag, off, rhs = _nested(4, 3, seed=5)
    one = lambda d, o, r: kb.solve_single(BlockTridiag(d, o), r)
    x = jax.vmap(jax.vmap(one))(diag, off, rhs)
    rx = jax.vmap(jax.vmap(
        lambda d, o, r: solve(BlockTridiag(d, o), r)))(diag, off, rhs)
    np.testing.assert_allclose(x, rx, atol=1e-12)


def _interpret(fn):
    return lambda *a, **k: fn(*a, **{**k, "block": 4, "interpret": True})


def test_rejects_state_dim_above_bound():
    s = kb.MAX_STATE_DIM + 1
    diag, off, rhs = random_batch(2, 3, s, seed=6)
    with pytest.raises(ValueError, match="state dim"):
        kb.gbp_covariance_logdet_kernel(
            jnp.asarray(diag), jnp.asarray(off), interpret=True
        )
    with pytest.raises(ValueError, match="state dim"):
        kb.solve_kernel(jnp.asarray(diag), jnp.asarray(off),
                        jnp.asarray(rhs), interpret=True)


def test_rejects_non_power_of_two_block():
    diag, off, _ = random_batch(2, 3, 2, seed=7)
    with pytest.raises(ValueError, match="power of two"):
        kb.gbp_covariance_logdet_kernel(
            jnp.asarray(diag), jnp.asarray(off), block=48, interpret=True
        )


@pytest.mark.parametrize("method", ["ngd", "prox"])
def test_engine_with_kernel_matches_seq(monkeypatch, method):
    """The full GVI loop with the engine's chain ops on the kernel
    (interpret mode) reproduces the seq-scan trajectory."""
    from gaussianvi_tpu.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu.inference import GVIConfig, optimize
    from gaussianvi_tpu.inference.engine import LocalEngine
    from gaussianvi_tpu.inference.optimize import chain_ops, run_gvi

    monkeypatch.setattr(
        kb, "gbp_covariance_logdet_kernel",
        _interpret(kb.gbp_covariance_logdet_kernel),
    )
    monkeypatch.setattr(kb, "solve_kernel", _interpret(kb.solve_kernel))
    graph, init, _ = build_chain_estimation(num_states=6, dim_x=1,
                                            gh_degree=3)
    config = GVIConfig(niters=3, niters_lowtemp=3, step_size_base=0.9)

    @jax.jit
    def run_kernel(graph, init):
        engine = LocalEngine(graph, config)
        engine._cov_fn, engine._solve_fn = chain_ops("kernel")
        return run_gvi(engine, init, config, method)

    st_k, hist_k = run_kernel(graph, init)
    st_s, hist_s = optimize(graph, init, config, method=method)
    np.testing.assert_allclose(hist_k.cost, hist_s.cost, rtol=1e-10)
    np.testing.assert_allclose(st_k.mu, st_s.mu, atol=1e-10)
