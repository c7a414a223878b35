"""Every Pallas-Triton kernel lowers for CUDA (jax.export, no GPU needed).

Lowering runs the Pallas -> Triton IR translation, which is where a kernel
using an operation the Triton route does not support, or a non-power-of-two
block, fails.  Compiling that IR to a cubin happens only on a card (chip_smoke.py
and the `gpu`-marked tests cover that)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import raster_pallas as rp
from d3d12_deferred_renderer_tpu.ops.gbuffer import GBuffer
from d3d12_deferred_renderer_tpu.ops.lighting_pallas import shade_pbr_tiled_pallas
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

TRITON_CALL = "__gpu$xla.gpu.triton"


def _lower_cuda(fn, *args):
    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(TRITON_CALL)],
    )(*args)
    return exp.mlir_module()


def _tris(cfg):
    geo = dxr.build_scene_geometry([dxr.procedural.cube(1.0)])
    state = dxr.animate(dxr.make_scene(geo, cfg))
    tris, vp = setup_frame_triangles(state, cfg)
    return tris, vp, state


@pytest.mark.parametrize("tile", [(8, 128), (16, 64), (32, 32)])
def test_raster_kernel_lowers(tile):
    cfg = dxr.RendererConfig(width=256, height=64, tile_h=tile[0], tile_w=tile[1])
    tris, _, _ = _tris(cfg)
    mlir = _lower_cuda(
        lambda p, a: rp.rasterize_binned(p, a, cfg, return_overflow=True),
        tris.packed, tris.aabb,
    )
    assert mlir.count(TRITON_CALL) == 1


def test_depth_kernel_lowers():
    cfg = dxr.RendererConfig(width=128, height=128, tile_h=16, tile_w=128)
    tris, _, _ = _tris(cfg)
    mlir = _lower_cuda(
        lambda p, a: rp.rasterize_depth(p, a, cfg), tris.packed, tris.aabb
    )
    assert mlir.count(TRITON_CALL) == 1


def test_band_raster_kernel_lowers_with_traced_offset_under_vmap():
    """The sharded paths: a traced band offset, and vmap over frames (the
    batched pallas_call gains a grid axis)."""
    cfg = dxr.RendererConfig(width=256, height=64)
    tris, _, _ = _tris(cfg)

    def band(p, a, y0):
        return rp.rasterize_binned(p, a, cfg, band_h=32, y_offset=y0).depth

    packed = jnp.stack([tris.packed, tris.packed])
    aabb = jnp.stack([tris.aabb, tris.aabb])
    mlir = _lower_cuda(
        jax.vmap(band, in_axes=(0, 0, None)), packed, aabb, jnp.int32(32)
    )
    assert mlir.count(TRITON_CALL) == 1


@pytest.mark.parametrize("with_vis", [False, True], ids=["no_vis", "vis"])
def test_shading_kernel_lowers(with_vis):
    cfg = dxr.RendererConfig(width=100, height=40, shading="pbr")
    geo = dxr.build_scene_geometry([dxr.procedural.cube(1.0)])
    lights = dxr.random_point_lights(8, cfg=cfg)
    state = dxr.animate(dxr.make_scene(geo, cfg, lights=lights))
    _, vp = setup_frame_triangles(state, cfg)
    rng = np.random.default_rng(0)
    gb = GBuffer(
        gb0=jnp.asarray(rng.uniform(size=(40, 100, 4)), jnp.float32),
        gb1=jnp.asarray(rng.uniform(size=(40, 100, 4)), jnp.float32),
        depth=jnp.asarray(rng.uniform(0.9, 1.0, (40, 100)), jnp.float32),
    )
    vis = jnp.ones((40, 100), jnp.float32) if with_vis else None
    mlir = _lower_cuda(
        lambda g, v: shade_pbr_tiled_pallas(
            g, state.lights, cfg, vp, state.camera.eye, shadow_visibility=v,
            y_offset=8, full_height=48,
        ),
        gb, vis,
    )
    assert mlir.count(TRITON_CALL) == 1
