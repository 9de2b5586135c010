"""GBP-vs-dense-inverse validation demo (reference src/GBP.cpp:133-158).

Random block-tridiagonal SPD precision, block dim 14, 20 states; prints the
maximum marginal-covariance error of belief propagation against the dense
inverse, for the scan and associative-scan engines.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main(num_states=20, dim_state=14, seed=0):
    # host demo: run on CPU in f64 (the config update must precede first
    # backend use)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from gaussianvi_tpu.ops.blocktridiag import BlockTridiag, gbp_covariance
    from gaussianvi_tpu.ops.parallel_chain import gbp_covariance_logdet_assoc

    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((num_states, dim_state, dim_state))
    diag = diag @ diag.transpose(0, 2, 1) + 3 * dim_state * np.eye(dim_state)
    off = 0.5 * rng.standard_normal((num_states - 1, dim_state, dim_state))
    A = BlockTridiag(jnp.asarray(diag), jnp.asarray(off))

    dense_cov = np.linalg.inv(np.asarray(A.to_dense()))

    for name, fn in (
        ("scan GBP ", lambda a: gbp_covariance(a)),
        ("assoc GBP", lambda a: gbp_covariance_logdet_assoc(a)[:2]),
    ):
        cd, co = fn(A)
        err_d = max(
            np.abs(
                np.asarray(cd[i])
                - dense_cov[i * dim_state:(i + 1) * dim_state,
                            i * dim_state:(i + 1) * dim_state]
            ).max()
            for i in range(num_states)
        )
        err_o = max(
            np.abs(
                np.asarray(co[i])
                - dense_cov[i * dim_state:(i + 1) * dim_state,
                            (i + 1) * dim_state:(i + 2) * dim_state]
            ).max()
            for i in range(num_states - 1)
        )
        print(f"{name}: max diag-block err {err_d:.3e}, "
              f"max off-block err {err_o:.3e}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
