"""Pinned-precision contractions for the framework's small-block algebra.

At DEFAULT matmul precision an accelerator may compute a float32
``einsum``/``@`` at reduced precision: on an NVIDIA H100, XLA may run float32
products in TF32 (~10 mantissa bits).  For this framework that is pure
accuracy loss with no meaningful speed win: every contraction here is
tiny-block algebra (d, s <= 8 states; M <= a few hundred sigma points),
far from tensor-core-bound, and reduced-precision products cost the
Hessian moment E[(x-mu)(x-mu)^T phi] digits the optimizer needs.  So every
accuracy-bearing contraction in the package routes through these wrappers
at ``HIGHEST``, which on the H100 is true float32 (no TF32).  On the CPU
the kwarg is a no-op.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_PRECISION = lax.Precision.HIGHEST


def set_contraction_precision(p) -> None:
    """Override the package-wide contraction precision (A/B experiments;
    accepts a ``lax.Precision`` or its string name).  Takes effect at the
    next trace — already-jitted callables keep what they captured."""
    global _PRECISION
    _PRECISION = lax.Precision(p) if isinstance(p, str) else p


def get_contraction_precision():
    return _PRECISION


def einsum(*args, **kwargs):
    """jnp.einsum at the pinned precision (true float32 products)."""
    return jnp.einsum(*args, precision=_PRECISION, **kwargs)


def matmul(a, b):
    """Drop-in for the @ operator on block matrices."""
    return jnp.matmul(a, b, precision=_PRECISION)
