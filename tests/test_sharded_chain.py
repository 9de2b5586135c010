"""Chain backends under shard_map on the 8-device CPU mesh.

``optimize_sharded`` resolves "auto" against the MESH's platform, with the
chain on the scans; the chain is (dp, fp)-local, so an explicit
``chain_impl="kernel"`` runs per shard with no collective crossing it.
Here the kernel runs in interpret mode inside shard_map
(``check_vma=False``: Pallas interpret mode cannot be traced under the
varying-axes type system) against the unsharded scans; the compiled kernel
under ``check_vma=True`` runs in ``chip_smoke.py --four-cards``.
"""

from dataclasses import replace
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from gaussianvi_tpu.examples.chain_estimation import build_chain_estimation
from gaussianvi_tpu.inference import GVIConfig
from gaussianvi_tpu.inference.optimize import optimize
from gaussianvi_tpu.kernels import chain_block as kb
from gaussianvi_tpu.ops.blocktridiag import (
    BlockTridiag,
    gbp_covariance_logdet,
    solve,
)
from gaussianvi_tpu.parallel.sharding import (
    FactorShardEngine,
    make_mesh,
    optimize_sharded,
    stack_problems,
)
from gaussianvi_tpu.ops.chain_oracle import random_chain as random_batch

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh"
)


def _problems(num, num_states=6, dim_x=1):
    graphs, states = [], []
    for seed in range(num):
        g, s0, _ = build_chain_estimation(
            num_states=num_states, dim_x=dim_x, gh_degree=3, seed=seed
        )
        graphs.append(g)
        states.append(s0)
    return stack_problems(graphs, states), graphs, states


class TestResolution:
    def test_cpu_mesh_resolves_to_scans(self):
        (graph_b, _), _, _ = _problems(1)
        g0 = jax.tree.map(lambda x: x[0], graph_b)
        eng = FactorShardEngine(g0, GVIConfig(), platform="cpu")
        assert eng.chain_impl == "seq"
        assert eng.sqrtm_method == "eigh"

    def test_gpu_mesh_resolves_to_scans(self):
        """Under shard_map "auto" keeps the scans on the GPU too; the
        single-device engine takes the kernel there."""
        from gaussianvi_tpu.inference.engine import LocalEngine

        (graph_b, _), _, _ = _problems(1)
        g0 = jax.tree.map(lambda x: x[0], graph_b)
        assert FactorShardEngine(g0, GVIConfig(),
                                 platform="gpu").chain_impl == "seq"
        assert LocalEngine(g0, GVIConfig(),
                           platform="gpu").chain_impl == "kernel"

    def test_explicit_impls_pass_through(self):
        (graph_b, _), _, _ = _problems(1)
        g0 = jax.tree.map(lambda x: x[0], graph_b)
        eng = FactorShardEngine(g0, GVIConfig(chain_impl="assoc"),
                                platform="cpu")
        assert (eng.chain_impl, eng.sqrtm_method) == ("assoc", "eigh")
        with pytest.raises(ValueError, match="GPU only"):
            FactorShardEngine(g0, GVIConfig(chain_impl="kernel"),
                              platform="cpu")


class TestKernelUnderShardMap:
    """The kernel's single-problem entry points, vmapped over each shard's
    problems inside shard_map, vs the unsharded scans."""

    def _batch(self, seed):
        diag, off, rhs = random_batch(8, 5, 3, seed=seed)
        return (jnp.asarray(diag), jnp.asarray(off),
                jnp.asarray(rhs).reshape(8, -1))

    @pytest.mark.parametrize("dp", [4, 8])
    def test_cov_logdet(self, monkeypatch, dp):
        monkeypatch.setattr(
            kb, "gbp_covariance_logdet_kernel",
            partial(kb.gbp_covariance_logdet_kernel, block=2,
                    interpret=True),
        )
        diag, off, _ = self._batch(seed=dp)
        mesh = make_mesh(dp, 1)

        @partial(jax.shard_map, mesh=mesh, in_specs=(P("dp"), P("dp")),
                 out_specs=(P("dp"), P("dp"), P("dp")), check_vma=False)
        def run(d, o):
            return jax.vmap(lambda a, b: kb.gbp_covariance_logdet_single(
                BlockTridiag(a, b)))(d, o)

        got = jax.jit(run)(diag, off)
        ref = jax.vmap(
            lambda a, b: gbp_covariance_logdet(BlockTridiag(a, b))
        )(diag, off)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)

    @pytest.mark.parametrize("dp", [4, 8])
    def test_solve(self, monkeypatch, dp):
        monkeypatch.setattr(
            kb, "solve_kernel",
            partial(kb.solve_kernel, block=2, interpret=True),
        )
        diag, off, rhs = self._batch(seed=10 + dp)
        mesh = make_mesh(dp, 1)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P("dp"), P("dp"), P("dp")), out_specs=P("dp"),
                 check_vma=False)
        def run(d, o, r):
            return jax.vmap(lambda a, b, c: kb.solve_single(
                BlockTridiag(a, b), c))(d, o, r)

        got = jax.jit(run)(diag, off, rhs)
        ref = jax.vmap(
            lambda a, b, c: solve(BlockTridiag(a, b), c)
        )(diag, off, rhs)
        np.testing.assert_allclose(got, ref, atol=1e-12)


class TestShardedEquivalence:
    @pytest.mark.parametrize("method", ["ngd", "prox"])
    def test_sharded_assoc_matches_local(self, method):
        """optimize_sharded with an explicit chain_impl vs the local run
        with the SAME impl."""
        (graph_b, state_b), graphs, states = _problems(4)
        mesh = make_mesh(2, 2)
        config = GVIConfig(
            niters=3, niters_lowtemp=3, step_size_base=0.9,
            chain_impl="assoc",
        )
        st_sh, hist_sh = optimize_sharded(
            graph_b, state_b, config, mesh, method=method
        )
        for i, (g, s0) in enumerate(zip(graphs, states)):
            st_l, hist_l = optimize(g, s0, config, method=method)
            np.testing.assert_allclose(
                hist_sh.cost[i], hist_l.cost, rtol=1e-7
            )
            np.testing.assert_allclose(st_sh.mu[i], st_l.mu, atol=1e-7)

    def test_sharded_assoc_matches_sharded_seq(self):
        """The two sharded scan backends agree with each other (same psum
        structure, different chain recurrences)."""
        (graph_b, state_b), _, _ = _problems(4)
        mesh = make_mesh(2, 2)
        base = GVIConfig(niters=3, niters_lowtemp=3, step_size_base=0.9)
        st_a, hist_a = optimize_sharded(
            graph_b, state_b, replace(base, chain_impl="assoc"), mesh
        )
        st_s, hist_s = optimize_sharded(
            graph_b, state_b, replace(base, chain_impl="seq"), mesh
        )
        np.testing.assert_allclose(hist_a.cost, hist_s.cost, rtol=1e-7)
        np.testing.assert_allclose(st_a.mu, st_s.mu, atol=1e-7)
