"""The one place that chooses each frame stage's implementation.

Three stages have a hand-written fast path: the tile-binned raster (display,
depth prepass, shadow map, calibration), and tiled-deferred PBR shading.  The
rule is the same for all of them (``kernel_mode``):

* ``cfg.use_pallas`` off, or the CPU backend: the plain-XLA oracles
  (raster_ref.rasterize_packed, lighting.shade_pbr_tiled).
* GPU backend with ``cfg.use_pallas``: the Pallas-Triton kernels.  A config
  they cannot run raises; it never falls back to the oracle.
* Interpret mode (the same kernels run by the Pallas interpreter, for CPU
  tests and dry runs): only when a caller passes ``interpret=True``.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..config import RendererConfig
from .raster_ref import rasterize_packed

XLA, TRITON, INTERPRET = "xla", "triton", "interpret"


def _check_kernel_config(cfg: RendererConfig) -> None:
    """Raise for a config the Triton kernels cannot run: a Triton block is a
    power-of-two shape, so the raster tile must be one."""
    for name in ("tile_h", "tile_w"):
        v = getattr(cfg, name)
        if v <= 0 or v & (v - 1):
            raise ValueError(
                f"the Triton raster kernel needs power-of-two tiles, got "
                f"{name}={v}; use a power of two or use_pallas=False"
            )


def kernel_mode(cfg: RendererConfig, interpret: bool = False) -> str:
    """XLA, TRITON or INTERPRET for this config on this backend (module
    docstring)."""
    if not cfg.use_pallas:
        return XLA
    if interpret:
        _check_kernel_config(cfg)
        return INTERPRET
    backend = jax.default_backend()
    if backend == "cpu":
        return XLA
    if backend != "gpu":
        raise NotImplementedError(
            f"no kernels for the {backend!r} backend; use use_pallas=False"
        )
    _check_kernel_config(cfg)
    return TRITON


def rasterize(
    packed, aabb, cfg: RendererConfig, band_h: int | None = None, y_offset=0,
    interpret: bool = False,
):
    """Geometry raster of rows [y_offset, y_offset + band_h) (default: the
    whole frame) -> (FragmentPlanes, overflow)."""
    mode = kernel_mode(cfg, interpret)
    if mode == XLA:
        H = band_h or cfg.height
        ys = jnp.asarray(y_offset, jnp.float32) + 0.5 + jnp.arange(H, dtype=jnp.float32)
        xs = jnp.arange(cfg.width, dtype=jnp.float32) + 0.5
        py, px = jnp.meshgrid(ys, xs, indexing="ij")
        frags = rasterize_packed(packed, H, cfg.width, px=px, py=py)
        return frags, jnp.zeros((), jnp.int32)
    from .raster_pallas import rasterize_binned

    return rasterize_binned(
        packed, aabb, cfg, interpret=mode == INTERPRET, band_h=band_h,
        y_offset=y_offset, return_overflow=True,
    )


def rasterize_depth(packed, aabb, cfg: RendererConfig, interpret: bool = False):
    """Depth-only raster of the whole cfg.height x cfg.width target ->
    (depth [H, W], overflow)."""
    mode = kernel_mode(cfg, interpret)
    if mode == XLA:
        depth = rasterize_packed(packed, cfg.height, cfg.width).depth
        return depth, jnp.zeros((), jnp.int32)
    from .raster_pallas import rasterize_depth as depth_kernel

    return depth_kernel(
        packed, aabb, cfg, interpret=mode == INTERPRET, return_overflow=True
    )


def shade_pbr(
    gb, lights, cfg: RendererConfig, view_proj, eye, shadow_visibility=None,
    y_offset=0, full_height: int | None = None, interpret: bool = False,
):
    """Tiled-deferred PBR shading -> (linear HDR [H, W, 3], overflow)."""
    mode = kernel_mode(cfg, interpret)
    if mode == XLA:
        from .lighting import shade_pbr_tiled

        H, W = gb.depth.shape
        # A band's XLA cull tile divides the band (and the width).
        tile = 32 if full_height is None else math.gcd(32, H, W)
        return shade_pbr_tiled(
            gb, lights, cfg, view_proj, eye, tile=tile,
            shadow_visibility=shadow_visibility, y_offset=y_offset,
            full_height=full_height, return_overflow=True,
        )
    from .lighting_pallas import shade_pbr_tiled_pallas

    return shade_pbr_tiled_pallas(
        gb, lights, cfg, view_proj, eye, shadow_visibility=shadow_visibility,
        interpret=mode == INTERPRET, return_overflow=True, y_offset=y_offset,
        full_height=full_height,
    )

