"""Static policy test: accuracy-bearing contractions use pinned precision.

At DEFAULT matmul precision an accelerator may compute a float32
einsum/@ at reduced precision (TF32 on an NVIDIA GPU, ~3 decimal digits),
which costs the Hessian moment E[(x-mu)(x-mu)^T phi] digits the optimizer
needs.  ops/precision.py pins HIGHEST precision; this test keeps new
contractions from silently reintroducing the loss.
"""

import pathlib
import re

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "gaussianvi_tpu"

# modules whose contractions feed optimizer trajectories / covariances
GUARDED = [
    "factors/moments.py",
    "factors/priors.py",
    "factors/robots.py",
    "inference/gvi.py",
    "ops/blocktridiag.py",
    "ops/parallel_chain.py",
    "ops/psd.py",
    "parallel/chain_seqpar.py",
    "parallel/time_sharding.py",
    "samplers/target.py",
]

BARE_EINSUM = re.compile(r"(?<![\w.])jnp\.einsum\(")
# a @ b on array expressions (crude: any @ surrounded by spaces outside
# comments/strings is flagged; decorators start the line with @)
BARE_MATMUL = re.compile(r"\S\s@\s\S")


def _code_lines(path):
    """Source lines with comments and docstrings stripped (approximate)."""
    text = (PKG / path).read_text()
    # drop triple-quoted strings
    text = re.sub(r'"""[\s\S]*?"""', "", text)
    for line in text.split("\n"):
        yield line.split("#", 1)[0]


@pytest.mark.parametrize("rel", GUARDED)
def test_no_bare_contractions(rel):
    offenders = [
        line.strip()
        for line in _code_lines(rel)
        if BARE_EINSUM.search(line) or BARE_MATMUL.search(line)
    ]
    assert not offenders, (
        f"{rel} has contractions not routed through ops.precision "
        f"(DEFAULT matmul precision may be TF32): {offenders}"
    )


def test_wrappers_pin_highest():
    from jax import lax

    from gaussianvi_tpu.ops import precision

    assert precision.get_contraction_precision() == lax.Precision.HIGHEST
