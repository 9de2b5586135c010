"""Smoke test of the batched GVI engine on one NVIDIA GPU.

Drives the main path through the normal entry points at the repo's own
operating point and checks it against float64 host oracles, phase by
phase:

1. device: JAX devices, versions, XLA_FLAGS, compile cache, card and
   power limit;
2. NGD flagship: 1024 chain-estimation problems (N=32, s=4, degree-4
   rule), 10 iterations with the 11-trial batched line search, default
   implementations; problems 0-7 against an f64 CPU run;
3. prox at the same shape, at a step schedule on which the f64 run
   descends; problems 0-7 against an f64 CPU run;
4. planning: planar point robot (N=20, s=4, degree 3), 512 perturbed
   restarts; restarts 0-3 against an f64 CPU run;
5. the Pallas chain kernel, as the engine calls it (float64 on float32
   data), against the f64 dense oracle at the trial width (1024 x 11
   systems, N=32 and 128, s=4), beside the seq scans;
6. (``--timings`` only) timings that decide the GPU defaults: printed,
   not gated.

Each phase prints its numbers beside its tolerance.  The last line of
standard output is one JSON object ``{"ok": ..., "device": {...}}``; any
failed phase makes it ``"ok": false`` and the exit code non-zero.  Without
a GPU the script exits non-zero at once and prints no result.

    python chip_smoke.py                # one card, phases 1-5
    python chip_smoke.py --timings      # one card, phases 1 and 6
    python chip_smoke.py --four-cards   # the sharded paths on four cards
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
from concurrent.futures import ThreadPoolExecutor
import os
import statistics
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NGD_TOL = 1e-3      # f32 rounding + an accept decision flipping at the
                    # boundary; the same 10-iteration gate as before
PROX_TOL = 1e-3     # f32 rounding: 5.8e-6 over 256 problems on the CPU,
                    # while 10 iterations lower the cost by ~5%, so a
                    # wrong JKO step shows
PROX_STEP = 0.01    # prox step base: the GP prior's curvature (~12/dt^3)
                    # needs steps near 1e-4 = PROX_STEP**2; at 0.9 every
                    # trial is rejected and nothing moves
PLAN_TOL = 2e-2     # planner final cost: basin agreement on a kinked
                    # hinge cost (accept flips land in the same basin)
LOGDET_TOL = 1e-4   # kernel logdet error per state (absolute)
DESCENT_SHARE = 0.99
SHARD_TOL = 1e-3    # sharded vs single device: psum reassociation
TIMED_RUNS = 5
SHARDED_CHAIN = "seq"  # chain_impl "auto" under shard_map; the four-card
                       # single-device references run it too


def result_line(ok: bool, platform: str, kind: str, count: int) -> str:
    """The contract line: the last line of standard output."""
    return json.dumps(
        {"ok": bool(ok),
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def card_info() -> str:
    """Card name and power limit, read by nvidia-smi (no JAX client)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


class Phases:
    """Runs phases in order; a phase fails by raising (its traceback is
    printed) or by returning False."""

    def __init__(self):
        self.failed: list[str] = []

    def run(self, name, fn, *args):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            ok = fn(*args)
        except Exception:
            traceback.print_exc()
            ok = False
        status = "ok" if ok is not False else "FAILED"
        print(f"== phase {name}: {status} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if ok is False:
            self.failed.append(name)

    @property
    def ok(self) -> bool:
        return not self.failed


def check(label, value, tol) -> bool:
    ok = bool(value <= tol)
    print(f"  {label}: {value:.3e} (tolerance {tol:.0e}) "
          f"[{'ok' if ok else 'FAIL'}]", flush=True)
    return ok


def _to_host_f64(tree, n):
    """First n problems of a batched pytree as float64 host arrays."""
    import jax
    import numpy as np

    def one(x):
        x = np.asarray(x)[:n]
        return x.astype(np.float64) if x.dtype.kind == "f" else x

    return jax.tree.map(one, tree)


@contextlib.contextmanager
def _host_f64():
    """float64 on the host CPU (the oracle's precision and platform)."""
    import jax

    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        yield


def _oracle_costs(fn, *host_args):
    """Run ``fn`` (jittable) in float64 on the host CPU."""
    import jax
    import numpy as np

    with _host_f64():
        args = jax.device_put(host_args, jax.devices("cpu")[0])
        return np.asarray(jax.jit(fn)(*args), np.float64)


def _rel(a, b):
    import numpy as np

    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def _compile_all(pool, variants: dict) -> dict:
    """name -> (jitted fn, args): start compiling every variant at once,
    one thread each (XLA compiles outside the GIL); name -> future of
    (compiled, args)."""

    def one(name, fn, args):
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        print(f"  compiled {name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return compiled, args

    return {name: pool.submit(one, name, fn, args)
            for name, (fn, args) in variants.items()}


def _interleaved_medians(variants: dict) -> dict:
    """name -> (fn, args): warm each up, then TIMED_RUNS rounds that run
    every variant once per round; median seconds per variant."""
    import jax

    for fn, args in variants.values():
        jax.block_until_ready(fn(*args))
    times = {k: [] for k in variants}
    for _ in range(TIMED_RUNS):
        for k, (fn, args) in variants.items():
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


# -- workloads -----------------------------------------------------------------

def _f32():
    import jax.numpy as jnp

    return jnp.float32


FLAGSHIP = dict(num_problems=1024, num_states=32, dim_x=2, gh_degree=4)


def flagship_batch(**kw):
    """The flagship problem batch (float32 data)."""
    import bench

    return bench.build_batch(**{**FLAGSHIP, **kw}, dtype=_f32())


def flagship_config(**kw):
    from gaussianvi_tpu.inference import GVIConfig

    return GVIConfig(**{"niters": 10, "niters_lowtemp": 10,
                        "step_size_base": 0.9, **kw})


@functools.lru_cache(maxsize=None)
def batched_run(config, method):
    """jit(vmap(optimize)) over stacked problems -> (final state, costs
    [B, niters]); one compiled program per (config, method)."""
    import jax
    from gaussianvi_tpu.inference import optimize

    def one(g, s):
        state, hist = optimize(g, s, config, method=method)
        return state, hist.cost

    return jax.jit(jax.vmap(one))


def planner(num_restarts, **kw):
    """(graph, batched inits, config) of the planar planner."""
    import jax
    from gaussianvi_tpu.examples.planar_planning import build_planar_planning
    from gaussianvi_tpu.parallel.restarts import perturb_inits

    kw.setdefault("dtype", _f32())
    graph, init, cfg, _ = build_planar_planning(
        num_states=20, gh_degree=3, **kw
    )
    inits = perturb_inits(init, jax.random.key(0), num_restarts,
                          mean_scale=0.3)
    return graph, inits, cfg


def planner_run(graph, config):
    """jit(vmap(optimize)) over restarts of one planning graph -> costs
    [R, niters]."""
    import jax
    from gaussianvi_tpu.inference import optimize

    return jax.jit(jax.vmap(
        lambda s0: optimize(graph, s0, config, method="ngd")[1].cost
    ))


# -- phases --------------------------------------------------------------------

def phase_device():
    import jax
    import jaxlib
    from gaussianvi_tpu.utils.compile_cache import configure_compile_cache

    devs = jax.devices()
    print(f"  jax.devices(): {devs}")
    print(f"  device_kind: {devs[0].device_kind}")
    print(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"  XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  compile cache: {configure_compile_cache()}")
    print(f"  nvidia-smi: {card_info()}", flush=True)
    return True


def phase_ngd(ctx):
    import numpy as np

    graph_b, state_b = flagship_batch()
    cfg = flagship_config()
    t0 = time.perf_counter()
    _, cost = batched_run(cfg, "ngd")(graph_b, state_b)
    cost = np.asarray(cost, np.float64)
    print(f"  B=1024 N=32: compile + run {time.perf_counter() - t0:.1f} s")
    ctx["ngd"] = (graph_b, state_b)
    finite = bool(np.isfinite(cost).all())
    print(f"  all costs finite: {finite}")
    share = float(np.mean(cost[:, -1] < cost[:, 0]))
    ok = finite and share >= DESCENT_SHARE
    print(f"  cost fell on {share:.4f} of problems (need "
          f">= {DESCENT_SHARE}) [{'ok' if share >= DESCENT_SHARE else 'FAIL'}]")
    g8, s8 = _to_host_f64((graph_b, state_b), 8)
    cost64 = _oracle_costs(lambda g, s: batched_run(cfg, "ngd")(g, s)[1],
                           g8, s8)
    ok &= check("NGD max rel cost error, problems 0-7 x 10 iterations vs "
                "f64 CPU", _rel(cost[:8], cost64), NGD_TOL)
    return ok


def phase_prox(ctx):
    import numpy as np

    graph_b, state_b = ctx["ngd"]
    cfg = flagship_config(step_size_base=PROX_STEP)
    t0 = time.perf_counter()
    _, cost = batched_run(cfg, "prox")(graph_b, state_b)
    cost = np.asarray(cost, np.float64)
    print(f"  B=1024 N=32 step base {PROX_STEP}: compile + run "
          f"{time.perf_counter() - t0:.1f} s")
    finite = bool(np.isfinite(cost).all())
    print(f"  all costs finite: {finite}")
    share = float(np.mean(cost[:, -1] < cost[:, 0]))
    print(f"  cost fell on {share:.4f} of problems (need "
          f">= {DESCENT_SHARE}) [{'ok' if share >= DESCENT_SHARE else 'FAIL'}]")
    g8, s8 = _to_host_f64((graph_b, state_b), 8)
    cost64 = _oracle_costs(lambda g, s: batched_run(cfg, "prox")(g, s)[1],
                           g8, s8)
    drop = float(np.median(1.0 - cost64[:, -1] / cost64[:, 0]))
    print(f"  f64 oracle: median cost drop over 10 iterations {drop:.4f}")
    return finite & (share >= DESCENT_SHARE) & check(
        "prox max rel cost error, problems 0-7 x 10 iterations vs f64 CPU",
        _rel(cost[:8], cost64), PROX_TOL,
    )


def phase_planner():
    import numpy as np

    graph, inits, cfg = planner(512)
    run = planner_run(graph, cfg)
    t0 = time.perf_counter()
    cost = np.asarray(run(inits), np.float64)
    print(f"  512 restarts, N=20: compile + run "
          f"{time.perf_counter() - t0:.1f} s")
    finite = bool(np.isfinite(cost).all())
    print(f"  all costs finite: {finite}")
    # the oracle builds the planner (SDF included) in f64 on the host and
    # runs the device's first 4 perturbed inits
    with _host_f64():
        graph64, _, _ = planner(1, dtype=None)
    cost64 = _oracle_costs(planner_run(graph64, cfg), _to_host_f64(inits, 4))
    return finite & check(
        "planner rel final-cost error, restarts 0-3 vs f64 CPU",
        _rel(cost[:4, -1], cost64[:, -1]), PLAN_TOL,
    )


def _chain_fn(impl):
    """The engine's chain ops for ``impl`` (float64 on float32 data),
    vmapped over a batch: (diag, off, rhs) -> (cov diag, cov off, logdet,
    solve)."""
    import jax
    from gaussianvi_tpu.inference.optimize import chain_ops
    from gaussianvi_tpu.ops.blocktridiag import BlockTridiag

    cov, solve = chain_ops(impl)
    return jax.jit(lambda d, o, r: (
        *jax.vmap(lambda a, b: cov(BlockTridiag(a, b)))(d, o),
        jax.vmap(lambda a, b, c: solve(BlockTridiag(a, b), c.reshape(-1)))(
            d, o, r),
    ))


def phase_chain_kernel():
    import jax.numpy as jnp
    import numpy as np
    from gaussianvi_tpu.ops.chain_oracle import (
        chain_errors, dense_oracle, random_chain,
    )

    fns = {impl: _chain_fn(impl) for impl in ("seq", "kernel")}
    ok = True
    for n in (32, 128):
        diag, off, rhs = random_chain(1024 * 11, n, 4, seed=n,
                                      dtype=np.float32)
        ref = dense_oracle(diag[:64], off[:64], rhs[:64])
        args = tuple(jnp.asarray(x) for x in (diag, off, rhs))
        errs = {name: chain_errors([np.asarray(x[:64]) for x in fn(*args)],
                                   ref)
                for name, fn in fns.items()}
        (r_seq, l_seq), (r_k, l_k) = errs["seq"], errs["kernel"]
        print(f"  B=11264 N={n} s=4: max rel error kernel {r_k:.3e}, "
              f"seq {r_seq:.3e}; logdet error/state kernel {l_k:.3e}, "
              f"seq {l_seq:.3e}")
        ok &= check(f"N={n} kernel rel error / seq rel error",
                    r_k / r_seq, 2.0)
        ok &= check(f"N={n} kernel logdet error per state", l_k, LOGDET_TOL)
        # chain-level cost of the two (cov + logdet + solve), not gated
        times = _interleaved_medians({k: (fn, args)
                                      for k, fn in fns.items()})
        print(f"  B=11264 N={n} float64 chain on float32 data, "
              "cov+logdet+solve: "
              + ", ".join(f"{k} {t * 1e3:.3f} ms" for k, t in times.items()),
              flush=True)
    return ok


def _prox_gradients_run(method):
    """One prox iteration's JKO pseudo-gradients over the batch (the part
    the root decides) with ``sqrtm_product``'s ``method``."""
    import jax
    from gaussianvi_tpu.inference.gvi import prox_gradients
    from gaussianvi_tpu.inference.optimize import chain_ops

    cov = chain_ops("seq")[0]

    def one(g, s):
        cd, co, _ = cov(s.precision)
        return prox_gradients(g, s.mu, cd, co, PROX_STEP, method)

    return jax.jit(jax.vmap(one))


def phase_timings():
    """Medians of TIMED_RUNS interleaved runs of each variant beside the
    default; prob-iters/s = problems x iterations / time.  Every variant
    compiles at once; a comparison is timed as soon as its variants are
    ready, so the first ones print even if a later compile runs long."""
    from gaussianvi_tpu import resolve

    chain = resolve.chain_impl("gpu", "auto", 32, 4, 10**6)
    sqrtm = resolve.sqrtm_method("gpu", "auto")
    interp = resolve.sdf_interp("gpu", "auto")
    print(f"  defaults on this platform: chain_impl {chain}, sqrtm_method "
          f"{sqrtm}, interp {interp}", flush=True)

    def report(label, work, variants, default):
        for name, t in _interleaved_medians(variants).items():
            tag = " (default)" if name == default else ""
            rate = f" = {work / t:,.0f} prob-iters/s" if work else ""
            print(f"  {label} {name}{tag}: {t * 1e3:.3f} ms{rate}",
                  flush=True)

    batches = {n: flagship_batch(num_states=n) for n in (32, 128)}
    graph, inits, cfg = planner(512)
    runs = {f"N={n} {impl}": (batched_run(flagship_config(chain_impl=impl),
                                          "ngd"), batches[n])
            for n in batches for impl in resolve.CHAIN_IMPLS}
    runs.update({f"planner {i}": (planner_run(planner(1, interp=i)[0], cfg),
                                  (inits,))
                 for i in resolve.SDF_INTERPS})
    runs.update({f"prox {m}": (_prox_gradients_run(m), batches[32])
                 for m in resolve.SQRTM_METHODS})
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = _compile_all(pool, runs)

        def group(prefix):
            return {k[len(prefix):]: f.result() for k, f in futures.items()
                    if k.startswith(prefix)}

        for n in batches:
            report(f"NGD B=1024 N={n} 10 iterations, chain_impl", 1024 * 10,
                   group(f"N={n} "), chain)
        report("planner 512 restarts N=20 10 iterations, interp",
               512 * cfg.niters, group("planner "), interp)
        report("prox B=1024 N=32 JKO pseudo-gradients (one per iteration), "
               "sqrtm_method", 0, group("prox "), sqrtm)
    return True


# -- four cards ----------------------------------------------------------------

def _not_on_one_device(tree) -> bool:
    import jax

    return all(len(x.sharding.device_set) > 1 for x in jax.tree.leaves(tree))


def _dp4_planner(devs):
    """dp=4: 512 planner restarts."""
    import jax
    import jax.numpy as jnp
    from dataclasses import replace
    from gaussianvi_tpu.parallel import make_mesh, optimize_sharded

    graph, inits, cfg = planner(512)
    r = inits.mu.shape[0]
    graph_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (r,) + x.shape),
                           graph)
    _, hist = optimize_sharded(graph_b, inits, cfg, make_mesh(4, 1, devs))
    # the reference takes the same batched inputs (a program that closes
    # over the graph as constants folds them and rounds differently) and
    # the scans "auto" picks under shard_map
    ref = batched_run(replace(cfg, chain_impl=SHARDED_CHAIN), "ngd")(
        graph_b, inits)[1]
    return "dp=4 planner (512 restarts)", hist.cost, ref, hist.cost


def _dp2_fp2_flagship(devs):
    """dp=2 x fp=2: the flagship batch."""
    from gaussianvi_tpu.parallel import make_mesh, optimize_sharded

    graph_b, state_b = flagship_batch()
    _, hist = optimize_sharded(graph_b, state_b, flagship_config(),
                               make_mesh(2, 2, devs))
    ref = batched_run(flagship_config(chain_impl=SHARDED_CHAIN), "ngd")(
        graph_b, state_b)[1]
    return "dp=2 x fp=2 flagship (B=1024, N=32)", hist.cost, ref, hist.cost


def _sp4_chain(devs):
    """sp=4: one chain of 512 states, time-sharded."""
    import numpy as np
    from jax.sharding import Mesh
    from gaussianvi_tpu.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu.inference import optimize
    from gaussianvi_tpu.parallel import optimize_time_sharded, to_chain_layout

    g, s0, _ = build_chain_estimation(num_states=512, dim_x=2, gh_degree=4,
                                      dtype=_f32())
    cfg = flagship_config()
    st, hist = optimize_time_sharded(
        to_chain_layout(g), s0, cfg, Mesh(np.asarray(devs), ("sp",))
    )
    _, ref = optimize(g, s0, flagship_config(chain_impl=SHARDED_CHAIN))
    return "sp=4 chain estimation (N=512)", hist.cost, ref.cost, st.mu


def phase_four_cards():
    """The sharded paths on a four-card mesh, each against single-device
    ``optimize`` on the same problems; the three run concurrently, one
    thread each, so their compiles overlap."""
    import jax
    import numpy as np

    devs = jax.devices()[:4]
    with ThreadPoolExecutor(3) as pool:
        results = list(pool.map(lambda f: f(devs),
                                (_dp4_planner, _dp2_fp2_flagship, _sp4_chain)))
    ok = True
    for label, cost, ref, sharded_out in results:
        spread = _not_on_one_device(sharded_out)
        print(f"  {label}: outputs spread over the mesh: {spread}")
        ok &= spread & check(
            f"{label} max rel cost error vs single device",
            _rel(np.asarray(cost, np.float64), np.asarray(ref, np.float64)),
            SHARD_TOL,
        )
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four-cards", action="store_true",
                      help="run only the sharded paths on four cards")
    mode.add_argument("--timings", action="store_true",
                      help="run only the timings that decide the defaults")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r}); nothing was run",
              file=sys.stderr)
        return 2
    import gaussianvi_tpu  # noqa: F401  (fails outside the repo)

    # float32 data throughout; the engine runs the chain recurrences in
    # float64 and requires 64-bit types of every program that calls it
    # (ops.blocktridiag.in_float64), as the examples' entry points do
    jax.config.update("jax_enable_x64", True)

    count = 4 if args.four_cards else 1
    if len(jax.devices()) < count:
        print(f"chip_smoke: needs {count} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2
    phases = Phases()
    phases.run("1 device", phase_device)
    if args.four_cards:
        phases.run("E four cards", phase_four_cards)
    elif args.timings:
        phases.run("6 timings", phase_timings)
    else:
        ctx = {}
        phases.run("2 NGD flagship", phase_ngd, ctx)
        if "ngd" in ctx:
            phases.run("3 prox", phase_prox, ctx)
        else:
            phases.failed.append("3 prox (no flagship batch)")
        phases.run("4 planner", phase_planner)
        phases.run("5 chain kernel", phase_chain_kernel)
    if phases.failed:
        print(f"failed phases: {phases.failed}")
    dev = jax.devices()[0]
    print(card_info())
    print(result_line(phases.ok, dev.platform, dev.device_kind, count),
          flush=True)
    return 0 if phases.ok else 1


if __name__ == "__main__":
    sys.exit(main())
