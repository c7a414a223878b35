"""Tile-binned Triton rasterizer: bit-exact agreement with the reference
rasterizer (interpret mode on CPU) for several tile shapes, plus binning unit
tests."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.config import RendererConfig
from d3d12_deferred_renderer_tpu.ops.raster_pallas import (
    bin_triangles,
    rasterize_binned,
    rasterize_depth,
)
from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed
from d3d12_deferred_renderer_tpu.ops.transform import TRI_VALID, setup_frame_triangles

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")


def scene_tris(cfg, meshes=("cube", "pyramid")):
    geo = dxr.build_scene_geometry(
        [dxr.load_obj(os.path.join(ASSETS, f"{m}.obj"), prefer_native=False) for m in meshes]
    )
    state = dxr.make_scene(geo, cfg)
    state = dxr.animate(state)
    return setup_frame_triangles(state, cfg)[0]


# Raster-kernel tile shapes under test: the default and the alternatives the
# tile choice was measured against (all power-of-two Triton blocks).
TILES = [(8, 128), (16, 64), (32, 32)]


def _cfg(width, height, tile, **kw):
    return RendererConfig(width=width, height=height, tile_h=tile[0],
                          tile_w=tile[1], **kw)


def _assert_planes_equal(pal, ref):
    """Bit-identical fragment planes (same expressions, same order)."""
    for got, want in zip(pal, ref):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_binning_counts_and_order():
    cfg = RendererConfig(width=256, height=64, tile_h=8, tile_w=128,
                         max_tris_per_tile=32)
    tris = scene_tris(cfg)
    binned = bin_triangles(
        tris.packed, tris.aabb, tris.packed[:, TRI_VALID] > 0, cfg
    )
    counts = np.asarray(binned.counts)[:, 0]
    assert counts.sum() > 0
    assert counts.max() <= 32
    # K = min(max_tris_per_tile, T'); T' = 2 * 18 post-near-clip slots.
    T2 = tris.packed.shape[0]
    assert T2 == 36
    assert binned.idx.shape == (8 * 2, min(32, T2))
    # The flat path's record stream is the dense layout: tile t's segment is
    # its K-slot row (offs[t] = t * K), one 32-float record per row.
    st = binned.with_stream(tris.packed)
    assert st.stream.shape == (8 * 2 * 32, 32)
    assert st.offs.shape == (8 * 2 + 1,)
    np.testing.assert_array_equal(np.asarray(st.offs), np.arange(17) * 32)


@pytest.mark.parametrize("tile", TILES)
def test_pallas_matches_reference_scene(tile):
    cfg = _cfg(256, 64, tile)
    tris = scene_tris(cfg)
    ref = rasterize_packed(tris.packed, cfg.height, cfg.width)
    pal = rasterize_binned(tris.packed, tris.aabb, cfg, interpret=True)
    assert (np.asarray(ref.mesh_id) >= 0).any()
    _assert_planes_equal(pal, ref)


@pytest.mark.parametrize("tile", TILES)
def test_pallas_matches_reference_nondivisible_screen(tile):
    """Screen size not divisible by the tile size: padded tiles must crop away."""
    cfg = _cfg(200, 52, tile)
    tris = scene_tris(cfg)
    ref = rasterize_packed(tris.packed, cfg.height, cfg.width)
    pal = rasterize_binned(tris.packed, tris.aabb, cfg, interpret=True)
    assert pal.depth.shape == (52, 200)
    _assert_planes_equal(pal, ref)


@pytest.mark.parametrize("tile", TILES)
def test_pallas_depth_order_parity(tile):
    """Submission order must be preserved through binning (depth-equal first wins)."""
    import tests.test_raster as tr

    a = {"xy": [(0, 0), (64, 0), (0, 32)], "z": [0.5] * 3, "mesh_id": 1}
    b = {"xy": [(0, 0), (64, 0), (0, 32)], "z": [0.5] * 3, "mesh_id": 2}
    packed = tr.make_packed([a, b])
    aabb = jnp.asarray([[0, 0, 64, 32], [0, 0, 64, 32]], jnp.float32)
    cfg = _cfg(128, 32, tile)
    pal = rasterize_binned(packed, aabb, cfg, interpret=True)
    mid = np.asarray(pal.mesh_id)
    assert (mid >= 0).any()
    assert (mid[mid >= 0] == 1).all()
    _assert_planes_equal(pal, rasterize_packed(packed, 32, 128))


@pytest.mark.parametrize("tile", TILES)
def test_pallas_depth_only_matches_reference(tile):
    """The depth-only variant (shadow map, prepass, calibration) writes the
    full rasterizer's depth plane bit for bit."""
    cfg = _cfg(200, 52, tile)
    tris = scene_tris(cfg)
    ref = rasterize_packed(tris.packed, cfg.height, cfg.width)
    depth, overflow = rasterize_depth(
        tris.packed, tris.aabb, cfg, interpret=True, return_overflow=True
    )
    assert int(overflow) == 0
    np.testing.assert_array_equal(np.asarray(depth), np.asarray(ref.depth))


@pytest.mark.parametrize("traced", [False, True], ids=["static", "traced"])
@pytest.mark.parametrize("tile", TILES)
def test_pallas_band_matches_reference(tile, traced):
    """A band [y0, y0 + band_h) rasterizes exactly the oracle's rows; the
    offset may be a Python int or traced (the sharded path's axis_index)."""
    cfg = _cfg(128, 64, tile)
    tris = scene_tris(cfg)
    ref = rasterize_packed(tris.packed, cfg.height, cfg.width)
    y0, bh = 32, 32

    def band(off):
        return rasterize_binned(
            tris.packed, tris.aabb, cfg, interpret=True, band_h=bh, y_offset=off
        )

    pal = jax.jit(band)(jnp.int32(y0)) if traced else band(y0)
    _assert_planes_equal(pal, jax.tree.map(lambda a: a[y0 : y0 + bh], ref))


def test_pallas_full_frame_golden_equivalence():
    """Full frame program with the pallas rasterizer forced on (interpret) equals
    the pure-XLA frame."""
    cfg = RendererConfig(width=160, height=96, use_pallas=False)
    geo = dxr.build_scene_geometry(
        [dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False)]
    )
    state = dxr.make_scene(geo, cfg)
    state = dxr.animate(state)

    from d3d12_deferred_renderer_tpu.frame import render
    from d3d12_deferred_renderer_tpu.ops import gbuffer as gbm
    from d3d12_deferred_renderer_tpu.ops.lighting import shade_lambert
    from d3d12_deferred_renderer_tpu.ops import post

    ref_frame = np.asarray(render(state, cfg))

    tris, _ = setup_frame_triangles(state, cfg)
    frags = rasterize_binned(tris.packed, tris.aabb, cfg, interpret=True)
    gb = gbm.encode_gbuffer(frags, state.materials, cfg)
    color = shade_lambert(gb, state.lights, cfg)
    pal_frame = np.asarray(post.to_uint8(color))
    np.testing.assert_array_equal(pal_frame, ref_frame)
