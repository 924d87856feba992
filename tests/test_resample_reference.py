"""``warp_field`` against ``scipy.ndimage.map_coordinates``, including
displacements far past any bounded window and trailing extents of any size.

The engine treats the field as padded with the truncation value +1, and
blends with that fill across the grid edge; scipy's ``mode="grid-constant"``
with ``cval=1.0`` is that convention (``mode="constant"`` returns the fill
without blending for samples between the last voxel and the edge)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from levelsetfusion_tpu.ops.interpolation import warp_field


def _reference(field, warp):
    grid = np.meshgrid(*[np.arange(n) for n in field.shape], indexing="ij")
    coords = [g + warp[..., a] for a, g in enumerate(grid)]
    return ndimage.map_coordinates(
        field, coords, order=1, mode="grid-constant", cval=1.0
    )


@pytest.mark.parametrize("shape", [(16, 12, 10), (9, 13, 17), (20, 14)])
@pytest.mark.parametrize("scale", [0.5, 2.5, 8.0])
def test_warp_field_matches_scipy(shape, scale):
    rng = np.random.default_rng(len(shape) * 100 + int(scale * 10))
    field = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    warp = rng.uniform(-scale, scale, shape + (len(shape),)).astype(
        np.float32
    )
    got = jax.jit(warp_field)(jnp.asarray(field), jnp.asarray(warp))
    np.testing.assert_allclose(
        np.asarray(got), _reference(field, warp), atol=2e-6
    )


def test_warp_field_large_uniform_shift():
    """A 5.25-voxel shift along every axis of a z = 24 volume: interior
    values are the shifted field, and everything read from beyond the grid
    is the +1 fill."""
    rng = np.random.default_rng(5)
    shape = (12, 10, 24)
    field = rng.standard_normal(shape).astype(np.float32)
    warp = np.full(shape + (3,), 5.25, np.float32)
    got = np.asarray(warp_field(jnp.asarray(field), jnp.asarray(warp)))
    np.testing.assert_allclose(got, _reference(field, warp), atol=2e-6)
    inner = sum(
        (0.25 if a else 0.75) * (0.25 if b else 0.75) * (0.25 if c else 0.75)
        * field[5 + a:11 + a, 5 + b:9 + b, 5 + c:23 + c]
        for a in (0, 1) for b in (0, 1) for c in (0, 1)
    )
    np.testing.assert_allclose(got[:6, :4, :18], inner, atol=2e-6)
    np.testing.assert_array_equal(got[7:], 1.0)
    np.testing.assert_array_equal(got[:, 5:], 1.0)


def test_sharded_warp_field_past_old_window():
    """The voxel-block-sharded fusion gather is exact for per-voxel
    displacements up to its halo (here 5 voxels on the sharded axis and 6
    along the unsharded ones), well past a ±2-voxel window."""
    from levelsetfusion_tpu.parallel import make_mesh
    from levelsetfusion_tpu.parallel.sharded import warp_field_sharded

    rng = np.random.default_rng(9)
    shape = (32, 12, 20)
    live = jnp.asarray(np.tanh(rng.standard_normal(shape)).astype(np.float32))
    warp = np.empty(shape + (3,), np.float32)
    warp[..., 0] = rng.uniform(-5, 5, shape)
    warp[..., 1:] = rng.uniform(-6, 6, shape + (2,))
    got = warp_field_sharded(
        live, jnp.asarray(warp), mesh=make_mesh(4), live_halo=8
    )
    np.testing.assert_allclose(
        np.asarray(got), _reference(np.asarray(live), warp), atol=2e-6
    )
