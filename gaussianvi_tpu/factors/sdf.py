"""Signed-distance fields and hinge-loss obstacle costs.

Port of the reference's device-side SDF classes
(helpers/CudaOperation.h: PlanarSDF 21-131, SignedDistanceField 133-322) and
the obstacle cost used by every robot model (ibid. 491-region):

    cost(x) = sum_balls sigma * (slope * max(0, eps + radius - sd(ball)))^2

Here an SDF is a pytree of arrays.  Two interpolation backends:

* ``signed_distance`` — vectorized gather + bilinear/trilinear blend (the
  direct port; differentiable end-to-end — the reference carries a
  hand-written gradient, jax.grad reproduces it inside each cell).
* ``signed_distance_matmul`` — the gather-free formulation: the bilinear
  blend is a separable HAT-function contraction
  ``sd_q = sum_ij relu(1-|r_q-i|) relu(1-|c_q-j|) F[i, j]``
  (each hat vector has exactly the 2 nonzero bilinear weights), evaluated
  as dense one-hot MATMULS against the whole field — matrix work that
  scales with the batch instead of gathers.  The hats reproduce the
  4-corner/8-corner blend exactly (clamping included): identical values
  to the gather path up to the contraction precision
  (``_SDF_MATMUL_PRECISION``; exactly identical on CPU, where the
  precision kwarg is a no-op).  Which one a factor uses is resolved per
  platform (``resolve.sdf_interp``).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax


# Precision of the FIELD-WIDE hat contractions only (the tiny-block
# algebra is pinned to HIGHEST in ops/precision).  On an NVIDIA H100, XLA
# computes a float32 dot at HIGH in TF32 (~10 mantissa bits per product);
# interpolation is a convex combination of stored field values, so the
# error is relative to the field values, and chip_smoke.py checks the
# planner's costs against the float64 oracle.  Override for experiments
# via set_sdf_matmul_precision.
_SDF_MATMUL_PRECISION = lax.Precision.HIGH


def set_sdf_matmul_precision(p) -> None:
    """Override the SDF hat-contraction precision (A/B experiments;
    takes effect at the next trace)."""
    global _SDF_MATMUL_PRECISION
    _SDF_MATMUL_PRECISION = lax.Precision(p) if isinstance(p, str) else p


def _sdf_einsum(*args, **kwargs):
    return jnp.einsum(*args, precision=_SDF_MATMUL_PRECISION, **kwargs)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PlanarSDF:
    """2-D signed distance field on a regular grid.

    ``data[row, col]`` with row <-> y and col <-> x, origin at (x0, y0),
    uniform cell size — the reference's layout (CudaOperation.h:62-84).
    """

    data: jnp.ndarray      # [rows, cols]
    origin: jnp.ndarray    # [2] (x0, y0)
    cell_size: jnp.ndarray

    def point_to_cell(self, point: jnp.ndarray) -> jnp.ndarray:
        """(x, y) -> fractional (row, col), clamped to the field extent."""
        rows, cols = self.data.shape
        x = jnp.clip(
            point[..., 0],
            self.origin[0],
            self.origin[0] + (cols - 1.0) * self.cell_size,
        )
        y = jnp.clip(
            point[..., 1],
            self.origin[1],
            self.origin[1] + (rows - 1.0) * self.cell_size,
        )
        col = (x - self.origin[0]) / self.cell_size
        row = (y - self.origin[1]) / self.cell_size
        return jnp.stack([row, col], axis=-1)

    def signed_distance(self, points: jnp.ndarray) -> jnp.ndarray:
        """Bilinear-interpolated signed distance at points [..., 2] (x, y)."""
        idx = self.point_to_cell(points)
        r, c = idx[..., 0], idx[..., 1]
        rows, cols = self.data.shape
        lr = jnp.floor(r)
        lc = jnp.floor(c)
        lri = jnp.clip(lr.astype(jnp.int32), 0, rows - 1)
        lci = jnp.clip(lc.astype(jnp.int32), 0, cols - 1)
        hri = jnp.clip(lri + 1, 0, rows - 1)
        hci = jnp.clip(lci + 1, 0, cols - 1)
        wr = r - lr
        wc = c - lc
        d = self.data
        return (
            (1 - wr) * (1 - wc) * d[lri, lci]
            + wr * (1 - wc) * d[hri, lci]
            + (1 - wr) * wc * d[lri, hci]
            + wr * wc * d[hri, hci]
        )

    def signed_distance_matmul(self, points: jnp.ndarray) -> jnp.ndarray:
        """Bilinear interpolation as one-hot hat-function matmuls (see
        module docstring) — the gather-free path.  points [..., 2]."""
        idx = self.point_to_cell(points)
        r, c = idx[..., 0], idx[..., 1]
        rows, cols = self.data.shape
        wr = jnp.maximum(
            0.0, 1.0 - jnp.abs(r[..., None] - jnp.arange(rows, dtype=r.dtype))
        )
        wc = jnp.maximum(
            0.0, 1.0 - jnp.abs(c[..., None] - jnp.arange(cols, dtype=c.dtype))
        )
        # (wr @ F) then a row-reduction against wc: one [Q, rows] x
        # [rows, cols] contraction + a reduce — no gathers
        return _sdf_einsum("...i,ij,...j->...", wr, self.data, wc)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SDF3D:
    """3-D signed distance field, trilinear interpolation
    (CudaOperation.h:133-322; z stacked as the leading axis here)."""

    data: jnp.ndarray      # [z, rows, cols]
    origin: jnp.ndarray    # [3] (x0, y0, z0)
    cell_size: jnp.ndarray

    def signed_distance(self, points: jnp.ndarray) -> jnp.ndarray:
        nz, rows, cols = self.data.shape
        x = jnp.clip(
            points[..., 0],
            self.origin[0],
            self.origin[0] + (cols - 1.0) * self.cell_size,
        )
        y = jnp.clip(
            points[..., 1],
            self.origin[1],
            self.origin[1] + (rows - 1.0) * self.cell_size,
        )
        z = jnp.clip(
            points[..., 2],
            self.origin[2],
            self.origin[2] + (nz - 1.0) * self.cell_size,
        )
        c = (x - self.origin[0]) / self.cell_size
        r = (y - self.origin[1]) / self.cell_size
        zz = (z - self.origin[2]) / self.cell_size

        lr, lc, lz = jnp.floor(r), jnp.floor(c), jnp.floor(zz)
        lri = jnp.clip(lr.astype(jnp.int32), 0, rows - 1)
        lci = jnp.clip(lc.astype(jnp.int32), 0, cols - 1)
        lzi = jnp.clip(lz.astype(jnp.int32), 0, nz - 1)
        hri = jnp.clip(lri + 1, 0, rows - 1)
        hci = jnp.clip(lci + 1, 0, cols - 1)
        hzi = jnp.clip(lzi + 1, 0, nz - 1)
        wr, wc, wz = r - lr, c - lc, zz - lz
        d = self.data
        c00 = (1 - wr) * d[lzi, lri, lci] + wr * d[lzi, hri, lci]
        c01 = (1 - wr) * d[hzi, lri, lci] + wr * d[hzi, hri, lci]
        c10 = (1 - wr) * d[lzi, lri, hci] + wr * d[lzi, hri, hci]
        c11 = (1 - wr) * d[hzi, lri, hci] + wr * d[hzi, hri, hci]
        c0 = (1 - wc) * c00 + wc * c10
        c1 = (1 - wc) * c01 + wc * c11
        return (1 - wz) * c0 + wz * c1

    def signed_distance_matmul(self, points: jnp.ndarray) -> jnp.ndarray:
        """Trilinear interpolation as one-hot hat-function contractions
        (gather-free; see module docstring).  points [..., 3].

        Memory note: the (z, row) hats are combined into one
        ``[..., nz, rows]`` operand before the contraction against
        the field — for Q queries that intermediate is Q * nz * rows
        elements, so this path suits moderate fields/batches (the exact
        trilinear blend fundamentally needs a [Q, V^(2/3)] operand in
        any dense one-hot order)."""
        nz, rows, cols = self.data.shape
        x = jnp.clip(
            points[..., 0],
            self.origin[0],
            self.origin[0] + (cols - 1.0) * self.cell_size,
        )
        y = jnp.clip(
            points[..., 1],
            self.origin[1],
            self.origin[1] + (rows - 1.0) * self.cell_size,
        )
        z = jnp.clip(
            points[..., 2],
            self.origin[2],
            self.origin[2] + (nz - 1.0) * self.cell_size,
        )
        c = (x - self.origin[0]) / self.cell_size
        r = (y - self.origin[1]) / self.cell_size
        zz = (z - self.origin[2]) / self.cell_size
        wr = jnp.maximum(
            0.0, 1.0 - jnp.abs(r[..., None] - jnp.arange(rows, dtype=r.dtype))
        )
        wc = jnp.maximum(
            0.0, 1.0 - jnp.abs(c[..., None] - jnp.arange(cols, dtype=c.dtype))
        )
        wz = jnp.maximum(
            0.0, 1.0 - jnp.abs(zz[..., None] - jnp.arange(nz, dtype=zz.dtype))
        )
        wzr = wz[..., :, None] * wr[..., None, :]       # [..., nz, rows]
        t = _sdf_einsum("...zi,zij->...j", wzr, self.data)  # [..., cols]
        return jnp.sum(t * wc, axis=-1)


def hinge_obstacle_cost(
    signed_distances: jnp.ndarray,
    epsilon,
    radius,
    sigma,
    slope=1.0,
) -> jnp.ndarray:
    """sum_i sigma * (slope * max(0, eps + radius_i - sd_i))^2 over the last
    axis (the per-ball loop of cost_obstacle_planar)."""
    radius = jnp.broadcast_to(jnp.asarray(radius), signed_distances.shape)
    err = jnp.maximum(0.0, epsilon + radius - signed_distances) * slope
    return jnp.sum(err * err * sigma, axis=-1)
