"""Optimizer configuration.

The reference configures via setter methods with these defaults
(gvibase/GVI-GH.h:51-53, 91-93: niters_lowtemp=10, niters_backtrack=10,
stop_err=1e-5, step_size_base=0.55, trial decay x0.75).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GVIConfig:
    niters: int = 10
    niters_lowtemp: int = 10
    niters_backtrack: int = 10
    temperature: float = 1.0
    high_temperature: float = 10.0
    step_size_base: float = 0.55
    step_decay: float = 0.75
    stop_err: float = 1e-5
    # EMA-smoothed proposal update: accepted iterate is
    # alpha * new + (1 - alpha) * current (the CUDA variant's set_alpha,
    # GVI-GH-Cuda-impl.h:112-114; 1.0 = plain update, the reference default)
    ema_alpha: float = 1.0
    # chain-recurrence implementation: "seq" (O(N)-depth scans, the least
    # total work), "assoc" (O(log N)-depth associative scans, for very long
    # chains), "kernel" (the Pallas chain kernel, kernels/chain_block.py;
    # GPU only) or "auto" -- resolved per platform and shape by
    # gaussianvi_tpu.resolve.chain_impl
    chain_impl: str = "auto"
    # "auto" picks "assoc" over "seq" for chains at least this long
    assoc_threshold: int = 1_000_000
    # line-search evaluation strategy; both select the IDENTICAL iterate
    # (the first sufficiently-decreasing trial of the same schedule,
    # GVI-GH-impl.h:76-118):
    #   "batched" — all niters_backtrack+1 trial steps evaluated as one
    #               vmapped cost computation (one wide kernel);
    #   "seq"     — lax.while_loop that stops at the first accepted trial
    #               (the reference's sequential shrink; evaluates ~1 trial
    #               per iteration at steady state instead of all 11)
    linesearch: str = "batched"
    # quantize the sigma-point OFFSETS (x - mu) to this dtype before
    # evaluating phi ("bfloat16" / "float16"; None = full precision) —
    # compresses the [K, M, d] sigma-offset tensor, the hot loop's largest
    # intermediate.  phi itself and all weighted reductions stay in the
    # state dtype, and because the quantization is CENTERED at the marginal
    # mean it is immune to the catastrophic cancellation of absolute-bf16
    # evaluation (measured envelope on residual costs: bf16 < 3e-3, fp16
    # < 1e-4 relative E[phi] error — tests/test_chain_estimation.py).
    # NGD path only (prox stays full precision).
    moments_eval_dtype: str | None = None
