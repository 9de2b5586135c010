"""Pivot-trust guard on the chain logdet.

An f32 accept loop can collapse when a near-indefinite trial precision's
Cholesky produces tiny POSITIVE rounding-noise pivots — a hugely negative
finite "logdet" that the line search then accepts.  The guard
(chain_block._pivot_trust / blocktridiag._guarded_logdet) poisons the
logdet with NaN when any pivot retains fewer than ~3 significant bits, so
such trials are REJECTED like the reference's f64-NaN non-SPD proposals.
"""

import numpy as np
import jax.numpy as jnp

from gaussianvi_tpu.kernels.chain_block import gbp_covariance_logdet_kernel
from gaussianvi_tpu.ops.blocktridiag import (
    BlockTridiag,
    _guarded_logdet,
    gbp_covariance_logdet,
)


class TestGuardStatistic:
    def test_healthy_pivots_pass(self):
        pivots = jnp.broadcast_to(jnp.eye(3), (4, 3, 3)) * 2.0
        diag = pivots
        msgs = jnp.zeros_like(pivots)
        ld = _guarded_logdet(pivots, diag, msgs)
        assert np.isfinite(float(ld))
        np.testing.assert_allclose(float(ld), 4 * 3 * np.log(2.0), rtol=1e-12)

    def test_noise_pivots_poisoned(self):
        """Pivot magnitude at rounding-noise level relative to what
        cancelled (diag 1.0 vs message -1.0) -> NaN, not log(noise)."""
        s = 2
        pivots = jnp.broadcast_to(jnp.eye(s) * 1e-18, (3, s, s))
        diag = jnp.broadcast_to(jnp.eye(s), (3, s, s))
        msgs = -diag
        ld = _guarded_logdet(pivots, diag, msgs)
        assert np.isnan(float(ld))

    def test_legitimate_small_pivots_pass(self):
        """Genuinely small diagonal entries with NO cancellation keep their
        full relative accuracy and must not be poisoned."""
        pivots = jnp.broadcast_to(jnp.eye(2) * 1e-12, (2, 2, 2))
        ld = _guarded_logdet(pivots, pivots, jnp.zeros_like(pivots))
        assert np.isfinite(float(ld))


class TestChainPaths:
    def _cancelling_chain(self):
        """2-state 1x1-block chain whose Schur pivot cancels to ~2 ulp:
        D1 - b^2 / D0 = 4e-16 with D0 = b = 1."""
        diag = jnp.asarray([[[1.0]], [[1.0 + 4e-16]]])
        off = jnp.asarray([[[1.0]]])
        return diag, off

    def test_scan_path_poisons(self):
        diag, off = self._cancelling_chain()
        *_, ld = gbp_covariance_logdet(BlockTridiag(diag, off))
        assert np.isnan(float(ld))

    def test_kernel_path_poisons(self):
        diag, off = self._cancelling_chain()
        *_, ld = gbp_covariance_logdet_kernel(
            diag[None], off[None], block=1, interpret=True
        )
        assert np.isnan(float(ld[0]))

    def test_paths_agree_on_healthy_chain(self):
        rng = np.random.default_rng(0)
        b, n, s = 5, 6, 3
        d = rng.standard_normal((b, n, s, s))
        d = d @ np.swapaxes(d, -1, -2) + 4 * np.eye(s)
        o = 0.3 * rng.standard_normal((b, n - 1, s, s))
        d, o = jnp.asarray(d), jnp.asarray(o)
        import jax

        _, _, ld_scan = jax.vmap(
            lambda dd, oo: gbp_covariance_logdet(BlockTridiag(dd, oo))
        )(d, o)
        _, _, ld_kernel = gbp_covariance_logdet_kernel(
            d, o, block=4, interpret=True
        )
        assert np.isfinite(np.asarray(ld_scan)).all()
        np.testing.assert_allclose(ld_kernel, ld_scan, rtol=1e-12)
