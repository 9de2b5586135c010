"""Eigh-free JKO root: scaled Denman-Beavers vs the eigh oracle.

``ops.psd.sqrtm_product`` has ``method='newton'`` — a determinant-scaled
Denman-Beavers iteration built entirely on the loop-free small-matrix
Cholesky algebra — beside the eigenbasis form.  ``'auto'`` resolves per
platform (gaussianvi_tpu.resolve.sqrtm_method); the CPU (the f64
golden-parity path) keeps eigh.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from gaussianvi_tpu.ops.psd import sqrtm_product


def _spd(rng, k, d, kappa):
    g = rng.standard_normal((k, d, d))
    q, _ = np.linalg.qr(g)
    w = np.exp(rng.uniform(0.0, np.log(kappa), (k, d)))
    a = np.einsum("kij,kj,klj->kil", q, w, q)
    return 0.5 * (a + np.swapaxes(a, -1, -2))


class TestNewtonVsEigh:
    @pytest.mark.parametrize("kappa,tol", [
        (1.0, 1e-12),
        (1e4, 1e-11),
        # kappa(B) ~ kappa(A)^2 ~ 1/eps_f64: the 1e-7 bound is the
        # conditioning floor of the product form, far below the f32
        # working precision this method deploys at
        (1e8, 1e-7),
    ])
    def test_matches_eigh_f64(self, kappa, tol):
        rng = np.random.default_rng(0)
        a = jnp.asarray(_spd(rng, 64, 4, kappa))
        ref = np.asarray(sqrtm_product(a, 0.59, method="eigh"))
        new = np.asarray(sqrtm_product(a, 0.59, method="newton"))
        rel = np.abs(new - ref).max() / np.abs(ref).max()
        assert rel < tol, rel

    def test_near_singular_floor(self):
        """An exactly-tiny eigenvalue of A (the eigh path clamps at 0)
        must not blow up the inverses: the trace-scaled jitter floors B."""
        rng = np.random.default_rng(1)
        w0 = np.array([[1e-14, 0.5, 2.0, 8.0]]).repeat(8, 0)
        q, _ = np.linalg.qr(rng.standard_normal((8, 4, 4)))
        a = np.einsum("kij,kj,klj->kil", q, w0, q)
        a = jnp.asarray(0.5 * (a + np.swapaxes(a, -1, -2)))
        ref = np.asarray(sqrtm_product(a, 0.59, method="eigh"))
        new = np.asarray(sqrtm_product(a, 0.59, method="newton"))
        assert np.isfinite(new).all()
        rel = np.abs(new - ref).max() / np.abs(ref).max()
        assert rel < 5e-6, rel

    def test_f32_accuracy(self):
        rng = np.random.default_rng(2)
        a = jnp.asarray(_spd(rng, 32, 4, 1e4), jnp.float32)
        ref = np.asarray(sqrtm_product(a, 0.59, method="eigh"))
        new = np.asarray(sqrtm_product(a, 0.59, method="newton"))
        rel = np.abs(new - ref).max() / np.abs(ref).max()
        assert rel < 2e-4, rel

    def test_auto_resolves_by_backend(self):
        """'auto' is the resolver's choice for the target platform: eigh on
        the CPU (bit-stable golden-parity path), the measured default on
        the GPU."""
        from gaussianvi_tpu import resolve

        a = jnp.asarray(_spd(np.random.default_rng(3), 4, 4, 10.0))
        assert resolve.target_platform() == "cpu"
        assert resolve.sqrtm_method("cpu", "auto") == "eigh"
        assert resolve.sqrtm_method("gpu", "auto") in ("eigh", "newton")
        auto = np.asarray(sqrtm_product(a, 0.59))
        eigh = np.asarray(sqrtm_product(a, 0.59, method="eigh"))
        np.testing.assert_array_equal(auto, eigh)

    def test_prox_e2e_newton_matches_eigh(self):
        """Full prox loop with the newton root vs the eigh root: same
        trajectory to working precision (CPU, forced methods)."""
        from gaussianvi_tpu.examples.chain_estimation import (
            build_chain_estimation,
        )
        from gaussianvi_tpu.inference import GVIConfig, optimize
        from gaussianvi_tpu.inference import gvi as gvi_mod

        graph, init, _ = build_chain_estimation(
            num_states=8, dim_x=1, gh_degree=4
        )
        cfg = GVIConfig(niters=8, niters_lowtemp=8, step_size_base=0.9)
        run = optimize.__wrapped__  # traced afresh for each root
        hist = {}
        with pytest.MonkeyPatch.context() as mp:
            # the root the engine resolved is overridden by each method
            for m in ("eigh", "newton"):
                mp.setattr(gvi_mod, "sqrtm_product",
                           lambda a, s, _, m=m: sqrtm_product(a, s, m))
                hist[m] = run(graph, init, cfg, method="prox")[1]
        h_e, h_n = hist["eigh"], hist["newton"]
        ce = np.asarray(h_e.cost, np.float64)
        cn = np.asarray(h_n.cost, np.float64)
        assert np.isfinite(cn).all()
        np.testing.assert_allclose(cn, ce, rtol=1e-9)
