"""Shadow-mapping correctness: an occluder between the light and a ground plane
must darken the ground region under it (and only with shadows enabled)."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.shadows import (
    light_view_proj,
    orthographic_lh,
    render_shadow_map,
    shadow_visibility,
)
from d3d12_deferred_renderer_tpu import xmath


def _blocker_scene(cfg):
    """Ground plane at y=-1 with a cube floating at the origin; light straight down-ish."""
    meshes = [dxr.procedural.ground_plane(size=12.0, y=-1.0), dxr.procedural.cube(1.2)]
    geo = dxr.build_scene_geometry(meshes)
    state = dxr.make_scene(geo, cfg, placement="reference")
    # Keep both meshes at the origin column, no animation yaw.
    state = dataclasses.replace(
        state,
        position=jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.5, 0.0]], jnp.float32),
        orientation=jnp.zeros((2, 3), jnp.float32),
    )
    return state


def test_orthographic_lh_depth_range():
    m = orthographic_lh(10.0, 10.0, 0.1, 50.0)
    near = np.asarray(xmath.transform_points(jnp.asarray([0.0, 0.0, 0.1]), m))
    far = np.asarray(xmath.transform_points(jnp.asarray([0.0, 0.0, 50.0]), m))
    assert near[2] / near[3] < 1e-6
    assert abs(far[2] / far[3] - 1.0) < 1e-6


def test_shadow_map_sees_occluder():
    cfg = dxr.RendererConfig(
        width=96, height=64, use_pallas=False, shading="pbr",
        shadows=True, shadow_map_size=128,
        light_direction=(-0.1, -1.0, -0.1),
    )
    state = _blocker_scene(cfg)
    depth, lvp = render_shadow_map(state, cfg)
    d = np.asarray(depth)
    assert (d < 1.0).any()          # something rendered
    assert d.min() >= 0.0


@pytest.mark.parametrize("size", [64, 96])
def test_shadow_map_depth_kernel_matches_oracle(size):
    """The shadow map through the depth kernel (interpret mode, light-view
    binning of shadow_bin_config) equals the oracle's map bit for bit, on a
    map that does and one that does not divide into raster tiles."""
    cfg = dxr.RendererConfig(
        width=96, height=64, shading="pbr", shadows=True,
        shadow_map_size=size, light_direction=(-0.3, -1.0, -0.2),
    )
    state = _blocker_scene(cfg)
    got, lvp, overflow = render_shadow_map(
        state, cfg, return_overflow=True, interpret=True
    )
    want, lvp_ref = render_shadow_map(
        state, dataclasses.replace(cfg, use_pallas=False)
    )
    assert int(overflow) == 0
    assert (np.asarray(want) < 1.0).any()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(lvp), np.asarray(lvp_ref))


def test_shadow_darkens_ground_under_cube():
    cfg = dxr.RendererConfig(
        width=96, height=64, use_pallas=False, shading="pbr",
        shadows=True, shadow_map_size=256, tonemap="none",
        light_direction=(-0.05, -1.0, -0.05),
    )
    state = _blocker_scene(cfg)

    from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles
    from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed

    tris, vp = setup_frame_triangles(state, cfg)
    frags = rasterize_packed(tris.packed, cfg.height, cfg.width)
    mid = np.asarray(frags.mesh_id)

    sm_depth, lvp = render_shadow_map(state, cfg)
    vis = np.asarray(
        shadow_visibility(frags.depth, vp, sm_depth, lvp, cfg)
    )

    ground = mid == 0
    assert ground.any()
    # Ground pixels under the cube (world |x|,|z| < 0.6) should be shadowed.
    from d3d12_deferred_renderer_tpu.ops.lighting import reconstruct_world_positions
    world = np.asarray(reconstruct_world_positions(frags.depth, vp, cfg))
    under = ground & (np.abs(world[..., 0]) < 0.45) & (np.abs(world[..., 2]) < 0.45)
    outside = ground & (np.abs(world[..., 0]) > 2.0)
    assert under.any() and outside.any()
    assert vis[under].mean() < 0.3, f"under-cube visibility {vis[under].mean()}"
    assert vis[outside].mean() > 0.9, f"open-ground visibility {vis[outside].mean()}"


def test_shadows_off_means_full_visibility_path():
    cfg_on = dxr.RendererConfig(
        width=96, height=64, use_pallas=False, shading="pbr", shadows=True,
        shadow_map_size=256, light_direction=(-0.05, -1.0, -0.05),
    )
    cfg_off = dataclasses.replace(cfg_on, shadows=False)
    state = _blocker_scene(cfg_on)
    _, on = dxr.step_frame(state, cfg_on)
    _, off = dxr.step_frame(state, cfg_off)
    on, off = np.asarray(on).astype(int), np.asarray(off).astype(int)
    # The shadowed image is strictly darker somewhere, never brighter.
    assert (on.sum(-1) < off.sum(-1)).any()
    assert on.max() <= off.max() + 1


def test_sparse_visibility_bit_equal_on_covered_tiles():
    """The covered-tile-compacted PCF must be BIT-identical to the dense path
    at every pixel of a covered (8, 128) tile, and exactly 1.0 on background
    tiles (whose pixels shade to black regardless of visibility)."""
    cfg = dxr.RendererConfig(
        width=256, height=64, use_pallas=False, shading="pbr",
        shadows=True, shadow_map_size=128, shadow_tiles_cap=-1,
        light_direction=(-0.1, -1.0, -0.1),
    )
    state = _blocker_scene(cfg)
    from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed
    from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

    tris, vp = setup_frame_triangles(state, cfg)
    frags = rasterize_packed(tris.packed, cfg.height, cfg.width)
    sd, lvp = render_shadow_map(state, cfg)

    dense = np.asarray(shadow_visibility(
        frags.depth, vp, sd, lvp,
        dataclasses.replace(cfg, shadow_tiles_cap=0),  # force dense
    ))
    sparse, overflow = shadow_visibility(
        frags.depth, vp, sd, lvp, cfg, return_overflow=True
    )
    sparse = np.asarray(sparse)
    assert int(overflow) == 0

    depth = np.asarray(frags.depth)
    TH, TW = 8, 128
    nty, ntx = cfg.height // TH, cfg.width // TW
    cov = depth.reshape(nty, TH, ntx, TW).min(axis=(1, 3)) < 1.0
    assert cov.any() and not cov.all()  # the scene exercises both cases
    for tyi in range(nty):
        for txi in range(ntx):
            sl = (slice(tyi * TH, (tyi + 1) * TH), slice(txi * TW, (txi + 1) * TW))
            if cov[tyi, txi]:
                np.testing.assert_array_equal(sparse[sl], dense[sl])
            else:
                np.testing.assert_array_equal(sparse[sl], 1.0)


def test_sparse_lit_cap_binds_and_stays_exact():
    """shadow_tiles_cap_lit (used only when a lit mask prunes the compaction):
    a cap holding the lit-covered tiles but NOT the full covered set must keep
    every lit pixel bit-identical to the dense path (pruned/uncompacted pixels
    return vis = 1.0, consumed by a zero directional term); a cap below the
    lit-covered count must overflow LOUDLY."""
    cfg = dxr.RendererConfig(
        width=256, height=64, use_pallas=False, shading="pbr",
        shadows=True, shadow_map_size=128, shadow_tiles_cap=-1,
        light_direction=(-0.1, -1.0, -0.1),
    )
    state = _blocker_scene(cfg)
    from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed
    from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

    tris, vp = setup_frame_triangles(state, cfg)
    frags = rasterize_packed(tris.packed, cfg.height, cfg.width)
    sd, lvp = render_shadow_map(state, cfg)
    depth = np.asarray(frags.depth)

    TH, TW = 8, 128
    nty, ntx = cfg.height // TH, cfg.width // TW
    cov = depth.reshape(nty, TH, ntx, TW).min(axis=(1, 3)) < 1.0
    cov_tiles = [(ty, tx) for ty in range(nty) for tx in range(ntx) if cov[ty, tx]]
    assert len(cov_tiles) >= 2  # need a strict lit subset below

    # Lit mask restricted to ONE covered tile: the lit-covered count (1) is
    # strictly below the covered count, so a lit cap of 8 binds the
    # compaction tighter than the covered set while still holding it.
    lit = np.zeros((cfg.height, cfg.width), bool)
    ty0, tx0 = cov_tiles[0]
    lit[ty0 * TH:(ty0 + 1) * TH, tx0 * TW:(tx0 + 1) * TW] = (
        depth[ty0 * TH:(ty0 + 1) * TH, tx0 * TW:(tx0 + 1) * TW] < 1.0
    )
    lit_j = jnp.asarray(lit)

    dense = np.asarray(shadow_visibility(
        frags.depth, vp, sd, lvp,
        dataclasses.replace(cfg, shadow_tiles_cap=0),  # force dense
    ))
    cfg_lit = dataclasses.replace(cfg, shadow_tiles_cap_lit=8)
    sparse, overflow = shadow_visibility(
        frags.depth, vp, sd, lvp, cfg_lit, return_overflow=True,
        lit_mask=lit_j,
    )
    sparse = np.asarray(sparse)
    assert int(overflow) == 0
    np.testing.assert_array_equal(sparse[lit], dense[lit])  # bit-identical
    # Pruned tiles (covered but not lit) return vis = 1.0.
    ty1, tx1 = cov_tiles[1]
    np.testing.assert_array_equal(
        sparse[ty1 * TH:(ty1 + 1) * TH, tx1 * TW:(tx1 + 1) * TW], 1.0
    )

    # More lit-covered tiles than the lit cap: loud overflow, never silent.
    lit_all = jnp.asarray(depth < 1.0)
    _, ovf = shadow_visibility(
        frags.depth, vp, sd, lvp,
        dataclasses.replace(cfg, shadow_tiles_cap_lit=1),
        return_overflow=True, lit_mask=lit_all,
    )
    assert int(ovf) > 0


def test_sparse_visibility_overflow_is_loud():
    """Covered tiles beyond shadow_tiles_cap must raise the overflow counter
    (never a silent wrong image)."""
    cfg = dxr.RendererConfig(
        width=256, height=64, use_pallas=False, shading="pbr",
        shadows=True, shadow_map_size=128, shadow_tiles_cap=1,
        light_direction=(-0.1, -1.0, -0.1),
    )
    state = _blocker_scene(cfg)
    from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed
    from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

    tris, vp = setup_frame_triangles(state, cfg)
    frags = rasterize_packed(tris.packed, cfg.height, cfg.width)
    sd, lvp = render_shadow_map(state, cfg)
    _, overflow = shadow_visibility(
        frags.depth, vp, sd, lvp, cfg, return_overflow=True
    )
    assert int(overflow) > 0


def test_window_gather_bit_equals_per_pixel_gather():
    """The 4x4-window quad path (shadow_window_gather) must be bit-identical
    to the per-pixel quad-gather path on every pixel, including wide-footprint
    quads routed through the fallback."""
    cfg = dxr.RendererConfig(
        width=256, height=64, use_pallas=False, shading="pbr",
        shadows=True, shadow_map_size=128, shadow_tiles_cap=-1,
        shadow_window_gather=True,  # the path under test (default is off)
        light_direction=(-0.1, -1.0, -0.1),
    )
    state = _blocker_scene(cfg)
    from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed
    from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

    tris, vp = setup_frame_triangles(state, cfg)
    frags = rasterize_packed(tris.packed, cfg.height, cfg.width)
    sd, lvp = render_shadow_map(state, cfg)

    win, ov_w = shadow_visibility(
        frags.depth, vp, sd, lvp, cfg, return_overflow=True
    )
    per_px, ov_p = shadow_visibility(
        frags.depth, vp, sd, lvp,
        dataclasses.replace(cfg, shadow_window_gather=False),
        return_overflow=True,
    )
    assert int(ov_w) == 0 and int(ov_p) == 0
    np.testing.assert_array_equal(np.asarray(win), np.asarray(per_px))


def test_window_gather_bad_quad_overflow_is_loud():
    """More wide-footprint quads than shadow_bad_quads_cap must raise the
    overflow counter (never a silently wrong image)."""
    cfg = dxr.RendererConfig(
        width=256, height=64, use_pallas=False, shading="pbr",
        shadows=True, shadow_map_size=128, shadow_tiles_cap=-1,
        shadow_window_gather=True,  # the path under test (default is off)
        shadow_bad_quads_cap=8,  # the blocker scene has far more bad quads
        light_direction=(-0.1, -1.0, -0.1),
    )
    state = _blocker_scene(cfg)
    from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed
    from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

    tris, vp = setup_frame_triangles(state, cfg)
    frags = rasterize_packed(tris.packed, cfg.height, cfg.width)
    sd, lvp = render_shadow_map(state, cfg)
    _, overflow = shadow_visibility(
        frags.depth, vp, sd, lvp, cfg, return_overflow=True
    )
    assert int(overflow) > 0
