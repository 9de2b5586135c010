"""Platform choice in one place.

Every implementation choice that depends on the device -- the chain
recurrences (``GVIConfig.chain_impl``), the prox JKO root
(``ops.psd.sqrtm_product``'s ``method``) and the SDF interpolation of the
planning factors (``interp``) -- resolves ``"auto"`` here, from the
platform the computation lands on and the problem's shapes.  Two platforms are known:
``"gpu"`` (defaults chosen on an NVIDIA H100, PERF.md) and
``"cpu"`` (the float64 golden-parity path).  Any other platform raises
rather than assume a default for a device that was never measured.

Resolution happens at trace time: a function traced under one platform
keeps that choice.
"""

from __future__ import annotations

import jax

PLATFORMS = ("gpu", "cpu")
CHAIN_IMPLS = ("seq", "assoc", "kernel")
SQRTM_METHODS = ("eigh", "newton")
SDF_INTERPS = ("gather", "matmul")

# GPU defaults, measured on an H100 (chip_smoke.py --timings, PERF.md):
# the prox pseudo-gradients take less time with the eigh root than with
# newton's, and the planner less with gathers than with the hat matmul.
_GPU_SQRTM = "eigh"
_GPU_INTERP = "gather"


def target_platform() -> str:
    """Platform the next jit will land on: a ``jax.default_device``
    context if one is active, else the process default backend."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return getattr(dev, "platform", str(dev))
    return jax.default_backend()


def mesh_platform(mesh) -> str:
    """Platform of a mesh: its own devices decide, not the process."""
    return mesh.devices.flat[0].platform


def _check(platform: str) -> str:
    if platform not in PLATFORMS:
        raise ValueError(
            f"no implementation defaults for platform {platform!r}; "
            f"known platforms: {PLATFORMS}"
        )
    return platform


def chain_impl(platform: str, requested: str, num_states: int,
               state_dim: int, assoc_threshold: int,
               sharded: bool = False) -> str:
    """``GVIConfig.chain_impl`` for this platform and shape.

    ``"auto"``: on the GPU the Pallas chain kernel for state dims up to
    :data:`..kernels.chain_block.MAX_STATE_DIM`, else the scans; on the
    CPU the scans.  ``sharded`` (a program under ``shard_map``) takes the
    scans on every platform: the compiled kernel under ``shard_map`` has
    no passing four-card check yet.  Scans are ``"assoc"`` for chains of
    at least ``assoc_threshold`` states, else ``"seq"``.  An explicit
    ``"kernel"`` raises where the kernel cannot compile: off the GPU, or
    above its state-dim bound."""
    from .kernels.chain_block import MAX_STATE_DIM

    _check(platform)
    if requested not in CHAIN_IMPLS + ("auto",):
        raise ValueError(f"unknown chain_impl {requested!r}")
    if requested == "kernel":
        if platform != "gpu":
            raise ValueError(
                "chain_impl='kernel' compiles for the GPU only "
                f"(platform {platform!r})"
            )
        if state_dim > MAX_STATE_DIM:
            raise ValueError(
                f"chain_impl='kernel' supports state dim <= "
                f"{MAX_STATE_DIM}, got {state_dim}"
            )
        return requested
    if requested != "auto":
        return requested
    if platform == "gpu" and state_dim <= MAX_STATE_DIM and not sharded:
        return "kernel"
    return "assoc" if num_states >= assoc_threshold else "seq"


def sqrtm_method(platform: str, requested: str) -> str:
    """The JKO root of ``ops.psd.sqrtm_product``: ``"auto"`` is eigh on
    the CPU (the bit-stable golden-parity path) and the measured winner on
    the GPU."""
    _check(platform)
    if requested not in SQRTM_METHODS + ("auto",):
        raise ValueError(f"unknown sqrtm_method {requested!r}")
    if requested != "auto":
        return requested
    return _GPU_SQRTM if platform == "gpu" else "eigh"


def sdf_interp(platform: str, requested: str) -> str:
    """SDF interpolation of the planning factors: ``"auto"`` is direct
    gathers on the CPU and the measured winner on the GPU."""
    _check(platform)
    if requested not in SDF_INTERPS + ("auto",):
        raise ValueError(f"unknown interp {requested!r}")
    if requested != "auto":
        return requested
    return _GPU_INTERP if platform == "gpu" else "gather"
