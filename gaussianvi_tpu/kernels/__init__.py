from .chain_block import (
    gbp_covariance_logdet_kernel,
    gbp_covariance_logdet_single,
    solve_kernel,
    solve_single,
)

__all__ = [
    "gbp_covariance_logdet_kernel", "gbp_covariance_logdet_single",
    "solve_kernel", "solve_single",
]
