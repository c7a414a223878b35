"""Band-offset Triton rasterization and shading (the multi-chip screen-sharded fast path):
a band render must equal the corresponding rows of the full-frame render, with
both static and traced y offsets."""
import os

import jax
import jax.numpy as jnp
import numpy as np

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.config import RendererConfig
from d3d12_deferred_renderer_tpu.ops.raster_pallas import rasterize_binned
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")


def _tris(cfg):
    geo = dxr.build_scene_geometry(
        [
            dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False),
            dxr.load_obj(os.path.join(ASSETS, "pyramid.obj"), prefer_native=False),
        ]
    )
    state = dxr.make_scene(geo, cfg)
    state = dxr.animate(state)
    return setup_frame_triangles(state, cfg)[0]


def test_band_equals_full_rows_static_offset():
    cfg = RendererConfig(width=256, height=64, tile_h=8, tile_w=128)
    tris = _tris(cfg)
    full = rasterize_binned(tris.packed, tris.aabb, cfg, interpret=True)
    for y0, bh in [(0, 16), (16, 16), (40, 24)]:
        band = rasterize_binned(
            tris.packed, tris.aabb, cfg, interpret=True, band_h=bh, y_offset=y0
        )
        np.testing.assert_array_equal(
            np.asarray(band.mesh_id), np.asarray(full.mesh_id)[y0 : y0 + bh]
        )
        np.testing.assert_allclose(
            np.asarray(band.depth), np.asarray(full.depth)[y0 : y0 + bh], atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(band.normal), np.asarray(full.normal)[y0 : y0 + bh], atol=1e-5
        )


def test_band_traced_offset_under_jit():
    cfg = RendererConfig(width=256, height=64, tile_h=8, tile_w=128)
    tris = _tris(cfg)
    full = rasterize_binned(tris.packed, tris.aabb, cfg, interpret=True)

    @jax.jit
    def band_at(y0):
        f = rasterize_binned(
            tris.packed, tris.aabb, cfg, interpret=True, band_h=16, y_offset=y0
        )
        return f.depth, f.mesh_id

    for y0 in (0, 16, 32, 48):
        depth, mid = band_at(jnp.asarray(y0, jnp.int32))
        np.testing.assert_array_equal(
            np.asarray(mid), np.asarray(full.mesh_id)[y0 : y0 + 16]
        )
        np.testing.assert_allclose(
            np.asarray(depth), np.asarray(full.depth)[y0 : y0 + 16], atol=1e-6
        )


def test_sharded_pallas_band_matches_reference():
    """shard_map + interpret-mode Pallas bands == single-device pure-XLA frame."""
    from d3d12_deferred_renderer_tpu.parallel import make_mesh, render_sharded

    cfg = RendererConfig(width=128, height=32, tile_h=8, tile_w=128, use_pallas=True)
    geo = dxr.build_scene_geometry(
        [dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False)]
    )
    state = dxr.make_scene(geo, cfg)
    state = dxr.animate(state)
    mesh = make_mesh((1, 2), devices=jax.devices()[:2])
    sharded = np.asarray(render_sharded(state, cfg, mesh, pallas_interpret=True))
    import dataclasses
    single = np.asarray(dxr.render(state, dataclasses.replace(cfg, use_pallas=False)))
    np.testing.assert_array_equal(sharded, single)


def test_lighting_kernel_band_equals_full_rows():
    """The Triton shading kernel's band mode (U_Y0 + full_height) must
    reproduce the corresponding rows of the full-frame kernel exactly: light
    lists differ only by lights whose window is exactly zero at the band's
    pixels, and the kept lights accumulate in the same ascending order."""
    import dataclasses

    from d3d12_deferred_renderer_tpu.ops.gbuffer import GBuffer
    from d3d12_deferred_renderer_tpu.ops.lighting_pallas import (
        shade_pbr_tiled_pallas,
    )
    from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

    cfg = RendererConfig(
        width=128, height=32, tile_h=8, tile_w=128, shading="pbr",
        use_pallas=False,
    )
    geo = dxr.build_scene_geometry(
        [
            dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False),
            dxr.load_obj(os.path.join(ASSETS, "pyramid.obj"), prefer_native=False),
        ]
    )
    lights = dxr.random_point_lights(12, cfg=cfg, radius=3.0)
    state = dxr.make_scene(geo, cfg, lights=lights)
    state = dxr.animate(state)
    gb = dxr.render_gbuffer(state, cfg)
    _, view_proj = setup_frame_triangles(state, cfg)

    full = np.asarray(
        shade_pbr_tiled_pallas(
            gb, state.lights, cfg, view_proj, state.camera.eye, interpret=True
        )
    )
    for y0, bh in [(0, 16), (16, 16), (8, 24)]:
        band_gb = GBuffer(
            gb0=gb.gb0[y0 : y0 + bh],
            gb1=gb.gb1[y0 : y0 + bh],
            depth=gb.depth[y0 : y0 + bh],
        )
        band = np.asarray(
            shade_pbr_tiled_pallas(
                band_gb, state.lights, cfg, view_proj, state.camera.eye,
                interpret=True, y_offset=y0, full_height=cfg.height,
            )
        )
        np.testing.assert_array_equal(band, full[y0 : y0 + bh])


def test_sharded_pallas_pbr_lighting_matches_reference():
    """shard_map bands through the Pallas raster + Pallas lighting kernels
    (interpret mode) == single-device pure-XLA PBR frame (1-LSB accumulation
    -order tolerance, same bound as the XLA sharded PBR test)."""
    from d3d12_deferred_renderer_tpu.parallel import make_mesh, render_sharded

    cfg = RendererConfig(
        width=128, height=32, tile_h=8, tile_w=128, use_pallas=True,
        shading="pbr",
    )
    geo = dxr.build_scene_geometry(
        [dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False)]
    )
    lights = dxr.random_point_lights(8, cfg=cfg)
    state = dxr.make_scene(geo, cfg, lights=lights)
    state = dxr.animate(state)
    mesh = make_mesh((1, 2), devices=jax.devices()[:2])
    sharded, stats = render_sharded(
        state, cfg, mesh, pallas_interpret=True, return_stats=True
    )
    sharded = np.asarray(sharded)
    assert int(stats["overflow"]) == 0
    import dataclasses
    single = np.asarray(
        dxr.render(state, dataclasses.replace(cfg, use_pallas=False))
    )
    diff = np.abs(sharded.astype(int) - single.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 2e-3


def test_sharded_pallas_pbr_shadows_matches_reference():
    """Sharded bands with the full Pallas pipeline + shadows: the band-dense
    PCF visibility plane feeds the Triton shading kernel.  Must match the
    single-device pure-XLA render within the PBR accumulation tolerance."""
    import dataclasses

    from d3d12_deferred_renderer_tpu.parallel import make_mesh, render_sharded

    cfg = RendererConfig(
        width=128, height=32, tile_h=8, tile_w=128, use_pallas=True,
        shading="pbr", shadows=True, shadow_map_size=64,
    )
    geo = dxr.build_scene_geometry(
        [
            dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False),
            dxr.load_obj(os.path.join(ASSETS, "pyramid.obj"), prefer_native=False),
        ]
    )
    lights = dxr.random_point_lights(8, cfg=cfg)
    state = dxr.make_scene(geo, cfg, lights=lights)
    state = dxr.animate(state)
    mesh = make_mesh((1, 2), devices=jax.devices()[:2])
    sharded, stats = render_sharded(
        state, cfg, mesh, pallas_interpret=True, return_stats=True
    )
    sharded = np.asarray(sharded)
    assert int(stats["overflow"]) == 0
    single = np.asarray(
        dxr.render(state, dataclasses.replace(cfg, use_pallas=False))
    )
    diff = np.abs(sharded.astype(int) - single.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 2e-3
