"""Auto-calibration (calibrate.autotune): derived budgets must be
overflow-free over the whole orbit on scenes they were never hand-tuned for,
and the sort-path binning under calibrated budgets must still match the flat
oracle exactly."""
import dataclasses

import jax
import numpy as np
import pytest

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu import frame as fr
from d3d12_deferred_renderer_tpu.calibrate import autotune
from d3d12_deferred_renderer_tpu.ops import raster_pallas as rp
from d3d12_deferred_renderer_tpu.ops.transform import (
    TRI_VALID, setup_frame_triangles,
)


def _scene(cfg, scene="benchmark", n_lights=16):
    if scene == "colonnade":
        meshes = dxr.procedural.colonnade_meshes(
            n_columns=6, n_orbs=4, rings=8, segments=12
        )
        placement = "origin"
    else:
        meshes = dxr.procedural.benchmark_meshes(n=6, rings=8, segments=12)
        placement = "grid"
    geo = dxr.build_scene_geometry(meshes)
    lights = dxr.random_point_lights(n_lights, cfg=cfg, radius=1.2)
    return dxr.make_scene(
        geo, cfg, lights=lights, placement=placement,
        materials=dxr.Materials.varied(geo.num_meshes),
    )


@pytest.mark.parametrize("scene", ["benchmark", "colonnade"])
def test_autotune_overflow_free_over_orbit(scene):
    cfg = dataclasses.replace(
        dxr.FLAGSHIP_CONFIG, width=256, height=128, use_pallas=False,
        shadows=True, shadow_map_size=128, shadow_tiles_cap=-1,
    )
    state = _scene(cfg, scene)
    cal, report = autotune(state, cfg, yaw_steps=6, margin=0.3)

    # The derived caps must actually bind somewhere (tighter than "everything
    # maxed"), and respect alignments.
    T = state.geometry.tri_mesh_id.shape[0] * 2  # records = 2 per triangle
    assert cal.bin_max_small % 128 == 0 or cal.bin_max_small == T
    assert cal.shadow_tiles_cap % 8 == 0 or cal.shadow_tiles_cap == (
        (cfg.height // 8) * (cfg.width // 128)
    )
    assert cal.max_lights_per_tile <= state.lights.num_point
    assert report["measured"]["pairs_max"] > 0

    # Full orbit with the calibrated config: overflow-free on every sample.
    step = jax.jit(fr.render_stats, static_argnums=(1,))
    s = state
    for _ in range(6):
        s = fr.animate(s, 2.0 * np.pi / 6, cal)
        _, stats = step(s, cal)
        assert int(stats["overflow"]) == 0


@pytest.mark.parametrize("scene", ["benchmark", "colonnade"])
def test_autotune_shadow_tiers_bind_and_match_oracle(scene, monkeypatch):
    """Light-view-calibrated shadow tiers (autotune_shadow): the shadow bin
    under the derived budgets must match the flat oracle exactly and stay
    overflow-free over the orbit, while emitting fewer sort keys than the
    safe default tiers."""
    from d3d12_deferred_renderer_tpu.ops.shadows import (
        light_view_proj, setup_light_view_triangles, shadow_bin_config,
    )
    from d3d12_deferred_renderer_tpu.calibrate import autotune_shadow

    cfg = dataclasses.replace(
        dxr.FLAGSHIP_CONFIG, width=256, height=128, use_pallas=False,
        shadows=True, shadow_map_size=256,
    )
    state = _scene(cfg, scene)
    n_tris = state.geometry.tri_mesh_id.shape[0]
    cal, rep = autotune_shadow(state, cfg, yaw_steps=4, margin=0.3)
    assert cal.shadow_bin_tiers == rep["tiers"]

    def keys_of(c):
        s = shadow_bin_config(c, n_tris)
        nt = (-(-s.height // s.tile_h)) * (-(-s.width // s.tile_w))
        k = (max(s.bin_max_small, 0) * s.bin_expand
             + s.bin_max_medium * s.bin_expand_medium
             + s.bin_max_large * s.bin_expand_large)
        if s.bin_expand_large < nt:
            k += s.bin_max_big * nt
        return k

    assert keys_of(cal) < keys_of(cfg)

    scfg = shadow_bin_config(cal, n_tris)
    lvp = light_view_proj(state.lights.direction)
    s = state
    for _ in range(4):
        s = fr.animate(s, 2.0 * np.pi / 4, cal)
        tris = setup_light_view_triangles(s, cal, scfg, lvp)
        valid = tris.packed[:, TRI_VALID] > 0
        flat = rp.bin_triangles_flat(tris.packed, tris.aabb, valid, scfg)
        monkeypatch.setattr(rp, "FLAT_CELLS", 0)  # force the sort path
        srt = rp.bin_triangles(tris.packed, tris.aabb, valid, scfg)
        assert int(srt.overflow) == int(flat.overflow) == 0
        k = np.asarray(flat.counts)[:, 0]
        fi, si = np.asarray(flat.idx), np.asarray(srt.idx)
        for t in range(fi.shape[0]):
            np.testing.assert_array_equal(fi[t, : k[t]], si[t, : k[t]])


def test_autotune_sort_path_matches_flat_oracle(monkeypatch):
    """Calibrated tier budgets routed through the sort-based binning must
    reproduce the flat oracle exactly (the budgets are big enough by
    construction: autotune measured the per-tier occupancy maxima)."""
    cfg = dataclasses.replace(
        dxr.FLAGSHIP_CONFIG, width=256, height=128, use_pallas=False,
    )
    state = _scene(cfg)
    cal, _ = autotune(state, cfg, yaw_steps=4, margin=0.3)

    state = fr.animate(state, 0.7, cal)
    tris, _ = setup_frame_triangles(state, cal)
    valid = tris.packed[:, TRI_VALID] > 0
    flat = rp.bin_triangles_flat(tris.packed, tris.aabb, valid, cal)
    monkeypatch.setattr(rp, "FLAT_CELLS", 0)  # force the sort path
    srt = rp.bin_triangles(tris.packed, tris.aabb, valid, cal)
    assert int(srt.overflow) == int(flat.overflow) == 0
    k = np.asarray(flat.counts)[:, 0]
    fi, si = np.asarray(flat.idx), np.asarray(srt.idx)
    for t in range(fi.shape[0]):
        np.testing.assert_array_equal(fi[t, : k[t]], si[t, : k[t]])
