"""Per-phase device-time breakdown of the NGD iteration on the GPU.

Traces ``--calls`` runs of the full 10-iteration ``optimize`` at the
flagship shape (B problems x N=32 states, s=4; float32 data, 64-bit types
on as in ``chip_smoke.py``) with ``jax.profiler``, then reads the trace
with ``jax.profiler.ProfileData`` and prints, per NGD iteration:

* the device busy share of the traced window (union of the kernel
  intervals on the GPU's stream lines over the window);
* device time by XLA op (the "XLA Ops" line), largest first, with the
  share of all op time.  With XLA's command buffers on (the default) the
  loop runs as one CUDA graph and shows as one op; set
  ``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` to see the ops.

    python scripts/trace_breakdown.py [--batch 1024] [--calls 3]
"""

from __future__ import annotations

import argparse
import collections
import glob
import re
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax


def device_planes(profile):
    return [p for p in profile.planes if p.name.startswith("/device:GPU")]


def busy_share(plane, window_ns):
    """Union of the kernel intervals on the plane's stream lines over the
    traced window."""
    spans = sorted(
        (ev.start_ns, ev.start_ns + ev.duration_ns)
        for line in plane.lines if line.name.startswith("Stream")
        for ev in line.events
    )
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / window_ns if window_ns else float("nan")


def op_times(plane):
    """Device time by XLA op name (numeric suffixes merged), in ns: the
    "XLA Ops" line if the trace has one, else the stream lines' kernels
    by their ``hlo_op`` stat (kernel name where it has none)."""
    lines = ([ln for ln in plane.lines if ln.name == "XLA Ops"]
             or [ln for ln in plane.lines if ln.name.startswith("Stream")])
    agg = collections.defaultdict(float)
    for line in lines:
        for ev in line.events:
            name = str(dict(ev.stats).get("hlo_op", ev.name))
            agg[re.sub(r"[.\d]+$", "", name)] += ev.duration_ns
    return agg


def main():
    from gaussianvi_tpu.inference import GVIConfig
    from gaussianvi_tpu.inference.optimize import optimize

    import bench

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit("trace_breakdown traces the GPU; JAX found none")
    jax.config.update("jax_enable_x64", True)

    graph_b, state_b = bench.build_batch(args.batch, 32, 2, 4,
                                         dtype=jax.numpy.float32)
    config = GVIConfig(niters=10, niters_lowtemp=10, step_size_base=0.9)
    run = jax.jit(jax.vmap(lambda g, s: optimize(g, s, config)[0]))
    jax.block_until_ready(run(graph_b, state_b))        # compile

    niters = args.calls * config.niters
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            with jax.profiler.TraceAnnotation("traced_window"):
                for _ in range(args.calls):
                    out = run(graph_b, state_b)
                jax.block_until_ready(out)
        (path,) = glob.glob(td + "/**/*.xplane.pb", recursive=True)
        profile = jax.profiler.ProfileData.from_file(path)
        window = [
            ev for p in profile.planes if p.name.startswith("/host")
            for line in p.lines for ev in line.events
            if ev.name == "traced_window"
        ]
        window_ns = window[0].duration_ns if window else 0.0
        for plane in device_planes(profile):
            agg = op_times(plane)
            total = sum(agg.values())
            print(f"{plane.name}: B={args.batch} N=32, {args.calls} calls x "
                  f"{config.niters} iterations; device busy "
                  f"{busy_share(plane, window_ns):.3f} of the "
                  f"{window_ns / 1e6:.1f} ms window; XLA op time "
                  f"{total / niters / 1e3:.1f} us per iteration")
            for name, ns in sorted(agg.items(), key=lambda kv: -kv[1])[:15]:
                print(f"  {ns / niters / 1e3:9.1f} us/iter "
                      f"{ns / total * 100:5.1f}%  {name}")


if __name__ == "__main__":
    main()
