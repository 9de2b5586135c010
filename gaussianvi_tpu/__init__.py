"""gaussianvi_tpu — batched Gaussian Variational Inference over factor graphs.

A JAX/XLA/Pallas re-design of the capabilities of hzyu17/GaussianVI, run on
NVIDIA GPUs:
Gaussian VI ``q = N(mu, Lambda^{-1})`` with block-tridiagonal precision,
natural-gradient and Wasserstein-proximal optimizers, sparse Gauss-Hermite
quadrature for per-factor expectations, and Gaussian belief propagation for
marginal covariances — everything batched over factors and jitted on device.
"""

from .factors import (
    LinearFactorBatch,
    NonlinearFactorBatch,
    make_nonlinear_batch,
)
from .inference import (
    FactorGraph,
    GaussianState,
    GVIConfig,
    GVIHistory,
    optimize,
)
from .ops import BlockTridiag

__version__ = "0.1.0"

__all__ = [
    "FactorGraph", "GaussianState", "GVIConfig", "GVIHistory", "optimize",
    "BlockTridiag",
    "NonlinearFactorBatch", "LinearFactorBatch", "make_nonlinear_batch",
]
