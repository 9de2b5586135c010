"""The scan chain backends (``seq``: ops/blocktridiag, ``assoc``:
ops/parallel_chain) vs a dense float64 oracle: covariance blocks,
off-diagonal blocks, logdet and the block-Thomas solve, at the shapes the
chain kernel is tested at (tests/test_chain_kernel.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussianvi_tpu.ops.blocktridiag import (
    BlockTridiag,
    gbp_covariance_logdet,
    solve,
)
from gaussianvi_tpu.ops.chain_oracle import dense_oracle, random_chain
from gaussianvi_tpu.ops.parallel_chain import (
    gbp_covariance_logdet_assoc,
    solve_assoc,
)


_IMPLS = {
    "seq": (gbp_covariance_logdet, solve),
    "assoc": (gbp_covariance_logdet_assoc, solve_assoc),
}


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 5, 20, 32])
@pytest.mark.parametrize("impl", ["seq", "assoc"])
def test_matches_dense(impl, n, s):
    cov_fn, solve_fn = _IMPLS[impl]
    diag, off, rhs = random_chain(3, n, s, seed=10 * n + s)

    @jax.jit
    def run(d, o, r):
        cov = jax.vmap(lambda d, o: cov_fn(BlockTridiag(d, o)))(d, o)
        x = jax.vmap(
            lambda d, o, r: solve_fn(BlockTridiag(d, o), r.reshape(-1))
        )(d, o, r)
        return (*cov, x)

    cd, co, ld, x = run(jnp.asarray(diag), jnp.asarray(off),
                        jnp.asarray(rhs))
    rcd, rco, rld, rx = dense_oracle(diag, off, rhs)
    np.testing.assert_allclose(cd, rcd, atol=1e-12)
    np.testing.assert_allclose(co, rco, atol=1e-12)
    np.testing.assert_allclose(ld, rld, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(x).reshape(rx.shape), rx,
                               atol=1e-12)


def test_in_float64_runs_float32_inputs_in_float64():
    """With 64-bit types on, a float32 chain op computes in float64 and
    returns float32: the result is the float64 one rounded once."""
    from gaussianvi_tpu.ops.blocktridiag import in_float64

    diag, off, _ = random_chain(1, 12, 4, seed=1)
    prec32 = BlockTridiag(jnp.asarray(diag[0], jnp.float32),
                          jnp.asarray(off[0], jnp.float32))
    prec64 = jax.tree.map(lambda x: x.astype(jnp.float64), prec32)
    got = in_float64(gbp_covariance_logdet)(prec32)
    ref = gbp_covariance_logdet(prec64)
    for g, r in zip(got, ref):
        assert g.dtype == jnp.float32
        np.testing.assert_array_equal(g, r.astype(jnp.float32))


def test_in_float64_refuses_float32_without_x64():
    """No second, float32 chain path: without 64-bit types a float32 chain
    op raises."""
    from gaussianvi_tpu.ops.blocktridiag import in_float64

    diag, off, _ = random_chain(1, 4, 2, seed=3)
    with jax.enable_x64(False):
        prec32 = BlockTridiag(jnp.asarray(diag[0], jnp.float32),
                              jnp.asarray(off[0], jnp.float32))
        with pytest.raises(ValueError, match="enable 64-bit types"):
            in_float64(gbp_covariance_logdet)(prec32)


def test_in_float64_leaves_float64_inputs_alone():
    from gaussianvi_tpu.ops.blocktridiag import in_float64

    diag, off, rhs = random_chain(1, 6, 2, seed=2)
    prec = BlockTridiag(jnp.asarray(diag[0]), jnp.asarray(off[0]))
    b = jnp.asarray(rhs[0]).reshape(-1)
    np.testing.assert_array_equal(in_float64(solve)(prec, b), solve(prec, b))
