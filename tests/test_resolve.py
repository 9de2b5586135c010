"""Platform choice in one place (gaussianvi_tpu/resolve.py)."""

import jax
import pytest

from gaussianvi_tpu import resolve
from gaussianvi_tpu.kernels.chain_block import MAX_STATE_DIM

_BIG = 1_000_000


@pytest.mark.parametrize("platform,requested,n,s,threshold,expected", [
    ("gpu", "auto", 32, 4, _BIG, "kernel"),
    ("gpu", "auto", 512, MAX_STATE_DIM, _BIG, "kernel"),
    ("gpu", "auto", 32, MAX_STATE_DIM + 1, _BIG, "seq"),
    ("gpu", "auto", 256, 14, 128, "assoc"),
    ("gpu", "seq", 32, 4, _BIG, "seq"),
    ("gpu", "assoc", 32, 4, _BIG, "assoc"),
    ("gpu", "kernel", 32, 4, _BIG, "kernel"),
    ("cpu", "auto", 32, 4, _BIG, "seq"),
    ("cpu", "auto", 256, 4, 128, "assoc"),
    ("cpu", "seq", 32, 4, _BIG, "seq"),
    ("cpu", "assoc", 32, 4, _BIG, "assoc"),
])
def test_chain_impl(platform, requested, n, s, threshold, expected):
    assert resolve.chain_impl(platform, requested, n, s, threshold) == expected


@pytest.mark.parametrize("platform,requested,n,threshold,expected", [
    ("gpu", "auto", 32, _BIG, "seq"),
    ("gpu", "auto", 256, 128, "assoc"),
    ("gpu", "kernel", 32, _BIG, "kernel"),
    ("cpu", "auto", 32, _BIG, "seq"),
])
def test_chain_impl_under_shard_map(platform, requested, n, threshold,
                                    expected):
    """Sharded programs resolve "auto" to the scans; an explicit request
    still passes."""
    assert resolve.chain_impl(platform, requested, n, 4, threshold,
                              sharded=True) == expected


def test_chain_kernel_refused_off_the_gpu():
    with pytest.raises(ValueError, match="GPU only"):
        resolve.chain_impl("cpu", "kernel", 32, 4, _BIG)


def test_chain_kernel_refused_above_state_bound():
    with pytest.raises(ValueError, match="state dim"):
        resolve.chain_impl("gpu", "kernel", 32, MAX_STATE_DIM + 1, _BIG)


def test_unknown_chain_impl_raises():
    with pytest.raises(ValueError, match="unknown chain_impl"):
        resolve.chain_impl("gpu", "lanes", 32, 4, _BIG)


@pytest.mark.parametrize("platform,requested,expected", [
    ("cpu", "auto", "eigh"),
    ("gpu", "auto", resolve._GPU_SQRTM),
    ("cpu", "newton", "newton"),
    ("gpu", "eigh", "eigh"),
])
def test_sqrtm_method(platform, requested, expected):
    assert resolve.sqrtm_method(platform, requested) == expected


@pytest.mark.parametrize("platform,requested,expected", [
    ("cpu", "auto", "gather"),
    ("gpu", "auto", resolve._GPU_INTERP),
    ("cpu", "matmul", "matmul"),
    ("gpu", "gather", "gather"),
])
def test_sdf_interp(platform, requested, expected):
    assert resolve.sdf_interp(platform, requested) == expected


@pytest.mark.parametrize("fn,args", [
    (resolve.chain_impl, ("auto", 32, 4, _BIG)),
    (resolve.sqrtm_method, ("auto",)),
    (resolve.sdf_interp, ("auto",)),
])
@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_unknown_platform_raises(fn, args, platform):
    with pytest.raises(ValueError, match="no implementation defaults"):
        fn(platform, *args)


def test_unknown_options_raise():
    with pytest.raises(ValueError, match="unknown sqrtm_method"):
        resolve.sqrtm_method("gpu", "schur")
    with pytest.raises(ValueError, match="unknown interp"):
        resolve.sdf_interp("gpu", "patch")


def test_target_platform_honors_default_device():
    assert resolve.target_platform() == jax.default_backend()
    with jax.default_device(jax.devices("cpu")[0]):
        assert resolve.target_platform() == "cpu"


def test_mesh_platform_reads_the_mesh_devices():
    from gaussianvi_tpu.parallel.sharding import make_mesh

    assert resolve.mesh_platform(make_mesh(1, 1)) == "cpu"


def test_engine_resolves_through_the_resolver():
    from gaussianvi_tpu.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu.inference import GVIConfig
    from gaussianvi_tpu.inference.engine import LocalEngine

    graph, _, _ = build_chain_estimation(num_states=4, dim_x=1, gh_degree=3)
    eng = LocalEngine(graph, GVIConfig())
    assert (eng.chain_impl, eng.sqrtm_method) == ("seq", "eigh")
    with pytest.raises(ValueError, match="GPU only"):
        LocalEngine(graph, GVIConfig(chain_impl="kernel"))
    with pytest.raises(ValueError, match="no implementation defaults"):
        LocalEngine(graph, GVIConfig(), platform="rocm")
