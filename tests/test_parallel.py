"""Multi-device (8 virtual CPU devices) sharded-rendering tests: sharded output
must equal the single-device render exactly."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.parallel import (
    make_mesh,
    render_frames_batch_sharded,
    render_sharded,
)
from d3d12_deferred_renderer_tpu.parallel.sharded import animation_times

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")


def _scene(cfg, lights=None):
    geo = dxr.build_scene_geometry(
        [
            dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False),
            dxr.load_obj(os.path.join(ASSETS, "pyramid.obj"), prefer_native=False),
        ]
    )
    return dxr.make_scene(geo, cfg, lights=lights)


def test_eight_virtual_devices_present():
    assert jax.device_count() >= 8


def test_row_sharded_matches_single_device_lambert():
    cfg = dxr.RendererConfig(width=128, height=32, use_pallas=False)
    state = _scene(cfg)
    state = dxr.animate(state)
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    sharded = np.asarray(render_sharded(state, cfg, mesh))
    single = np.asarray(dxr.render(state, cfg))
    np.testing.assert_array_equal(sharded, single)


def test_row_sharded_matches_single_device_pbr():
    cfg = dxr.RendererConfig(width=128, height=32, use_pallas=False, shading="pbr")
    lights = dxr.random_point_lights(8, cfg=cfg)
    state = _scene(cfg, lights)
    state = dxr.animate(state)
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    sharded = np.asarray(render_sharded(state, cfg, mesh))
    single = np.asarray(dxr.render(state, cfg))
    # PBR band path uses band-local light culling; results must agree to 1 LSB.
    diff = np.abs(sharded.astype(int) - single.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 2e-3


def test_frame_and_row_sharded_batch():
    cfg = dxr.RendererConfig(width=128, height=32, use_pallas=False)
    state = _scene(cfg)
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    times = animation_times(0.0, 4)
    frames = np.asarray(
        render_frames_batch_sharded(state, times, cfg, mesh)
    )
    assert frames.shape == (4, 32, 128, 3)
    # Each batched frame equals the sequential single-device animation.
    s = state
    for i in range(4):
        s, f = dxr.step_frame(s, cfg)
        np.testing.assert_array_equal(frames[i], np.asarray(f))


def test_indivisible_height_raises():
    cfg = dxr.RendererConfig(width=128, height=30, use_pallas=False)
    state = _scene(cfg)
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        render_sharded(state, cfg, mesh)


def test_row_sharded_bloom_fxaa_bump_match_single_device():
    """Cross-pixel post filters across band boundaries: bloom (all-gathered
    downsampled bright field), FXAA (1-row ppermute halo), and normal mapping
    (block-aligned bands) must be BIT-identical to the single-chip render —
    no seams at band boundaries."""
    cfg = dxr.RendererConfig(
        width=256, height=128, use_pallas=False, shading="pbr",
        bloom=True, fxaa=True, normal_mapping=True,
    )
    lights = dxr.random_point_lights(8, cfg=cfg)
    state = _scene(cfg, lights)
    state = dxr.animate(state)
    mesh = make_mesh((1, 8), devices=jax.devices()[:8])  # bands of 16 rows
    sharded = np.asarray(render_sharded(state, cfg, mesh))
    single = np.asarray(dxr.render(state, cfg))
    # PBR band light culling can flip 1 LSB (band-local tile AABBs); the
    # filters themselves are exact, so the bound matches the plain PBR test.
    diff = np.abs(sharded.astype(int) - single.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 2e-3


def test_row_sharded_lambert_fxaa_exact():
    """Lambert has no band-local culling differences, so FXAA across bands
    must be exactly equal to the single-chip path."""
    cfg = dxr.RendererConfig(width=128, height=32, use_pallas=False, fxaa=True)
    state = _scene(cfg)
    state = dxr.animate(state)
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    sharded = np.asarray(render_sharded(state, cfg, mesh))
    single = np.asarray(dxr.render(state, cfg))
    np.testing.assert_array_equal(sharded, single)


def test_sharded_overflow_signal():
    """The sharded path must carry the no-silent-drop overflow signal: a light
    cap too small for the scene reports a nonzero count summed over bands, and
    the flagship-style config reports zero."""
    cfg = dxr.RendererConfig(
        width=128, height=32, use_pallas=False, shading="pbr",
        max_lights_per_tile=1,
    )
    lights = dxr.random_point_lights(16, cfg=cfg, radius=50.0)  # all overlap
    state = _scene(cfg, lights)
    state = dxr.animate(state)
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    _, stats = render_sharded(state, cfg, mesh, return_stats=True)
    assert int(stats["overflow"]) > 0

    ok_cfg = dxr.RendererConfig(width=128, height=32, use_pallas=False, shading="pbr")
    state2 = _scene(ok_cfg, dxr.random_point_lights(8, cfg=ok_cfg))
    _, stats2 = render_sharded(state2, ok_cfg, mesh, return_stats=True)
    assert int(stats2["overflow"]) == 0
    # The batch variant threads the same signal.
    bmesh = make_mesh((2, 2), devices=jax.devices()[:4])
    _, bstats = render_frames_batch_sharded(
        state2, animation_times(0.0, 2), ok_cfg, bmesh, return_stats=True
    )
    assert int(bstats["overflow"]) == 0


def test_band_local_shadow_downsample_raises():
    # shadow_vis_downsample > 1 interpolates band-locally and would silently
    # diverge from the single-chip render -> refused loudly.
    cfg = dxr.RendererConfig(
        width=128, height=32, use_pallas=False, shading="pbr",
        shadows=True, shadow_map_size=64, shadow_vis_downsample=2,
    )
    state = _scene(cfg)
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        render_sharded(state, cfg, mesh)


def test_band_misaligned_bloom_raises():
    # 4 bands of 9 rows: 9 % 4 != 0 -> the downsample grid would misalign.
    cfg = dxr.RendererConfig(
        width=128, height=36, use_pallas=False, shading="pbr", bloom=True
    )
    state = _scene(cfg)
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        render_sharded(state, cfg, mesh)


def test_band_misaligned_bump_raises():
    # 4 bands of 12 rows: 12 % 8 (the bump block height) != 0 -> blocks would
    # straddle band boundaries.
    cfg = dxr.RendererConfig(
        width=128, height=48, use_pallas=False, shading="pbr",
        normal_mapping=True,
    )
    state = _scene(cfg)
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        render_sharded(state, cfg, mesh)
