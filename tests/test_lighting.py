"""Lighting tests: Lambert parity formula, PBR sanity, per-tile light culling
exactness (tiled == unculled)."""
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12_deferred_renderer_tpu import xmath
from d3d12_deferred_renderer_tpu.config import RendererConfig
from d3d12_deferred_renderer_tpu.ops.gbuffer import GBuffer
from d3d12_deferred_renderer_tpu.ops.lighting import (
    cull_lights_to_tiles,
    reconstruct_world_positions,
    shade_lambert,
    shade_pbr,
    shade_pbr_tiled,
)
from d3d12_deferred_renderer_tpu.scene import Lights


def _gb(h=4, w=4, albedo=(0.8, 0.2, 0.2), normal=(0.0, 0.0, -1.0), depth=0.5,
        metal=0.0, rough=0.5):
    n = np.asarray(normal, np.float32)
    n = n / np.linalg.norm(n)
    gb0 = np.tile(np.asarray([*albedo, metal], np.float32), (h, w, 1))
    gb1 = np.tile(np.asarray([*(n * 0.5 + 0.5), rough], np.float32), (h, w, 1))
    return GBuffer(
        gb0=jnp.asarray(gb0), gb1=jnp.asarray(gb1),
        depth=jnp.full((h, w), depth, jnp.float32),
    )


def _dir_lights(direction=(-0.3, -0.2, -1.0), color=(1.0, 1.0, 1.0)):
    cfg = RendererConfig(light_direction=direction, light_color=color)
    return Lights.directional_only(cfg)


def test_lambert_matches_reference_formula():
    """lighting.hlsl:32-51 transcribed independently here as the oracle.
    -lightDir points along (0.3, 0.2, 1.0); pick a partially-lit normal."""
    cfg = RendererConfig()
    albedo_srgb = np.asarray([0.8, 0.2, 0.2], np.float32)
    normal = np.asarray([0.6, 0.0, 0.8], np.float32)  # dot with L in (0, 1)
    gb = _gb(albedo=tuple(albedo_srgb), normal=tuple(normal))
    lights = _dir_lights()
    out = np.asarray(shade_lambert(gb, lights, cfg))[0, 0]

    # Oracle (the _gb helper stores unquantized values, so no unorm rounding here).
    n_dec = normal / np.linalg.norm(normal)
    alb_lin = albedo_srgb.astype(np.float64) ** 2.2
    L = -np.asarray([-0.3, -0.2, -1.0])
    L = L / np.linalg.norm(L)
    brightness = max(0.0, min(1.0, float(n_dec @ L)))
    assert 0.05 < brightness < 0.95  # genuinely partial lighting
    expect = (alb_lin * (0.3 + 1.0 * brightness)) ** (1 / 2.2)
    np.testing.assert_allclose(out, expect, rtol=1e-4)


def test_lambert_backfacing_gets_ambient_only():
    cfg = RendererConfig()
    # Faces away from -lightDir == away from (0.3, 0.2, 1.0).
    gb = _gb(normal=(-0.3, -0.2, -1.0))
    out = np.asarray(shade_lambert(gb, _dir_lights(), cfg))[0, 0]
    alb_lin = np.asarray([0.8, 0.2, 0.2]) ** 2.2
    expect = (alb_lin * 0.3) ** (1 / 2.2)
    np.testing.assert_allclose(out, expect, rtol=1e-3)


def test_background_shades_to_black():
    """Cleared G-buffer (albedo 0) -> black, overwriting the cornflower clear —
    the reference's fullscreen-triangle quirk (main.cpp:294-307)."""
    cfg = RendererConfig()
    gb = GBuffer(
        gb0=jnp.zeros((4, 4, 4)), gb1=jnp.zeros((4, 4, 4)),
        depth=jnp.ones((4, 4)),
    )
    out = np.asarray(shade_lambert(gb, _dir_lights(), cfg))
    assert out.max() == 0.0


def test_reconstruct_world_positions_roundtrip():
    """Project a known world point, write its depth, reconstruct -> same point."""
    cfg = RendererConfig(width=64, height=64)
    view = xmath.look_at_lh(cfg.eye, cfg.at, cfg.up)
    proj = xmath.perspective_fov_lh(cfg.fov_y, 1.0, cfg.z_near, cfg.z_far)
    vp = view @ proj
    world = jnp.asarray([0.3, -0.4, 1.0])
    clip = np.asarray(xmath.transform_points(world, vp))
    ndc = clip[:3] / clip[3]
    px = int((ndc[0] + 1) * 32)
    py = int((1 - ndc[1]) * 32)
    depth = jnp.ones((64, 64), jnp.float32).at[py, px].set(float(ndc[2]))
    rec = np.asarray(reconstruct_world_positions(depth, vp, cfg))[py, px]
    # Pixel-center offset bounds the error; keep a loose tolerance.
    np.testing.assert_allclose(rec, np.asarray(world), atol=0.05)


def _point_lights(n=24, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    return Lights(
        direction=jnp.asarray([-0.3, -0.2, -1.0]),
        color=jnp.asarray([1.0, 1.0, 1.0]),
        point_position=jnp.asarray(pos),
        point_color=jnp.asarray(rng.uniform(0.2, 1, (n, 3)).astype(np.float32)),
        point_radius=jnp.full((n,), 3.0),
        point_intensity=jnp.full((n,), 1.5),
    )


def _scene_gb(h=64, w=64, seed=0):
    """A G-buffer with plausible varied depth/normals for culling tests."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = rng.uniform(0.9, 0.999, (h, w)).astype(np.float32)
    depth[: h // 4] = 1.0  # top band = background
    gb0 = np.concatenate(
        [rng.uniform(0.1, 1, (h, w, 3)).astype(np.float32),
         rng.uniform(0, 1, (h, w, 1)).astype(np.float32)], -1
    )
    gb1 = np.concatenate([(n * 0.5 + 0.5), rng.uniform(0.1, 1, (h, w, 1)).astype(np.float32)], -1)
    return GBuffer(gb0=jnp.asarray(gb0), gb1=jnp.asarray(gb1), depth=jnp.asarray(depth))


def _vp(cfg):
    view = xmath.look_at_lh(cfg.eye, cfg.at, cfg.up)
    proj = xmath.perspective_fov_lh(cfg.fov_y, cfg.aspect, cfg.z_near, cfg.z_far)
    return view @ proj


def test_tiled_equals_unculled():
    """Per-tile light culling must be EXACT: the attenuation window is zero at the
    culling radius, so culled shading == brute-force shading."""
    cfg = RendererConfig(width=64, height=64, shading="pbr")
    gb = _scene_gb()
    lights = _point_lights()
    vp = _vp(cfg)
    eye = jnp.asarray(cfg.eye)
    full = np.asarray(shade_pbr(gb, lights, cfg, vp, eye))
    tiled = np.asarray(shade_pbr_tiled(gb, lights, cfg, vp, eye, tile=16))
    np.testing.assert_allclose(tiled, full, rtol=1e-4, atol=1e-5)


def test_tiled_equals_unculled_nondivisible_screen():
    """Regression: screens not divisible by the culling tile previously lost point
    lighting in the border rows/cols (they were zero-padded instead of shaded)."""
    cfg = RendererConfig(width=100, height=90, shading="pbr")
    gb = _scene_gb(90, 100)
    lights = _point_lights()
    vp = _vp(cfg)
    eye = jnp.asarray(cfg.eye)
    full = np.asarray(shade_pbr(gb, lights, cfg, vp, eye))
    tiled = np.asarray(shade_pbr_tiled(gb, lights, cfg, vp, eye, tile=32))
    np.testing.assert_allclose(tiled, full, rtol=1e-4, atol=1e-5)


def test_culling_reduces_light_count():
    cfg = RendererConfig(width=64, height=64)
    gb = _scene_gb()
    lights = _point_lights(n=32)
    tl = cull_lights_to_tiles(gb.depth, lights, cfg, _vp(cfg), tile=16)
    counts = np.asarray(tl.counts)
    assert counts.max() <= 32
    assert counts.min() < 32  # at least one tile culled something
    # Background-only tiles cull everything.
    assert counts[0].max() == 0


def test_pbr_nonnegative_and_finite():
    cfg = RendererConfig(width=32, height=32, shading="pbr")
    gb = _scene_gb(32, 32)
    out = np.asarray(shade_pbr(gb, _point_lights(8), cfg, _vp(cfg), jnp.asarray(cfg.eye)))
    assert np.isfinite(out).all()
    assert (out >= 0).all()


def _kernel(*args, **kw):
    from d3d12_deferred_renderer_tpu.ops.lighting_pallas import (
        shade_pbr_tiled_pallas,
    )

    return shade_pbr_tiled_pallas(*args, interpret=True, return_overflow=True, **kw)


# The Triton shading kernel evaluates the XLA paths' expressions
# (lighting.ggx_planar, the same normalize and reconstruction sums), so the
# tolerance is float32-epsilon level, far below one u8 step.  The XLA CPU
# backend may still compile a transcendental (pow) differently in the
# kernel's loop than in the oracle's fusion; sharp GGX highlights amplify
# such an ulp to ~1e-3 relative on a few pixels, which _SPECULAR_TOL allows.
_KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)
_SPECULAR_TOL = dict(rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("with_vis", [False, True], ids=["no_vis", "vis"])
def test_pallas_shading_kernel_matches_xla_tiled(with_vis):
    """The Triton deferred-lighting kernel (interpret mode) must match the
    pure-XLA shade_pbr_tiled oracle, with and without a shadow-visibility
    plane attenuating the directional term, on a screen that does not divide
    into cull tiles."""
    cfg = RendererConfig(width=72, height=40, shading="pbr")
    gb = _scene_gb(h=40, w=72)
    lights = _point_lights(n=12)
    vp = _vp(cfg)
    eye = jnp.asarray(cfg.eye)
    vis = None
    if with_vis:
        rng = np.random.default_rng(11)
        vis = jnp.asarray(rng.uniform(0, 1, (40, 72)).astype(np.float32))
    ref = shade_pbr_tiled(gb, lights, cfg, vp, eye, tile=32, shadow_visibility=vis)
    out, overflow = _kernel(gb, lights, cfg, vp, eye, shadow_visibility=vis)
    assert int(overflow) == 0
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **_KERNEL_TOL)


def test_pallas_shading_kernel_matches_unculled():
    """Culled kernel shading equals brute-force shade_pbr (every light at every
    pixel): the cull is exact, so only float rounding separates them."""
    cfg = RendererConfig(width=64, height=32, shading="pbr")
    gb = _scene_gb(h=32, w=64)
    lights = _point_lights(n=12)
    vp = _vp(cfg)
    eye = jnp.asarray(cfg.eye)
    full = shade_pbr(gb, lights, cfg, vp, eye)
    out, _ = _kernel(gb, lights, cfg, vp, eye)
    np.testing.assert_allclose(np.asarray(out), np.asarray(full), **_SPECULAR_TOL)


def test_pallas_shading_kernel_overflow_count():
    """A light cap below the live count drops lights LOUDLY: the kernel
    reports the same overflowing-tile count as the XLA path and shades the
    same capped lists."""
    cfg = RendererConfig(width=64, height=32, shading="pbr", max_lights_per_tile=2)
    gb = _scene_gb(h=32, w=64)
    lights = _point_lights(n=12)
    vp = _vp(cfg)
    eye = jnp.asarray(cfg.eye)
    ref, ref_ovf = shade_pbr_tiled(
        gb, lights, cfg, vp, eye, tile=32, return_overflow=True
    )
    out, overflow = _kernel(gb, lights, cfg, vp, eye)
    assert int(ref_ovf) > 0
    assert int(overflow) == int(ref_ovf)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **_SPECULAR_TOL)


def test_pallas_shading_kernel_band_offset():
    """Band mode (y_offset + full_height) shades the band's rows of the full
    frame: compared against the XLA path run on the same band."""
    cfg = RendererConfig(width=64, height=64, shading="pbr")
    gb = _scene_gb(h=64, w=64)
    lights = _point_lights(n=12)
    vp = _vp(cfg)
    eye = jnp.asarray(cfg.eye)
    y0, bh = 40, 24
    band = GBuffer(gb0=gb.gb0[y0:], gb1=gb.gb1[y0:], depth=gb.depth[y0:])
    ref = shade_pbr_tiled(
        band, lights, cfg, vp, eye, tile=8, y_offset=y0, full_height=64
    )
    out, _ = _kernel(band, lights, cfg, vp, eye, y_offset=y0, full_height=64)
    assert out.shape == (bh, 64, 3)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **_SPECULAR_TOL)


def test_pallas_shading_kernel_zero_point_lights():
    """Directional light only (no point lights): no cull, empty light loop."""
    cfg = RendererConfig(width=64, height=32, shading="pbr")
    gb = _scene_gb(h=32, w=64)
    lights = _dir_lights()
    vp = _vp(cfg)
    eye = jnp.asarray(cfg.eye)
    ref = shade_pbr(gb, lights, cfg, vp, eye)
    out, overflow = _kernel(gb, lights, cfg, vp, eye)
    assert int(overflow) == 0
    assert np.asarray(out).max() > 0
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **_SPECULAR_TOL)
