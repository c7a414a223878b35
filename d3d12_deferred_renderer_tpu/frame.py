"""The frame program: one jitted function = one frame.

Where the reference records a command list per frame (clear -> geometry pass ->
barriers -> lighting pass -> barriers -> present, main.cpp:161-342), the renderer
compiles the whole chain ONCE into a single XLA program: vertex transform ->
rasterize -> G-buffer encode -> (shadows) -> lighting -> post -> uint8.  Barriers are
structural (functional dataflow), command-list reuse is XLA's compiled executable,
and there are zero host syncs inside a frame.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .config import RendererConfig
from .ops import dispatch, post
from .ops.gbuffer import GBuffer, encode_gbuffer
from .ops.lighting import shade_lambert
from .ops.shadows import render_shadow_map, shadow_visibility
from .ops.transform import setup_frame_triangles
from .scene import SceneState, animate


def render_stats(state: SceneState, cfg: RendererConfig):
    """Render one frame -> (uint8 [H, W, 3], stats) where stats carries the
    per-tile capacity ``overflow`` count (tiles that dropped triangles or
    lights because a K cap was exceeded).  Zero on every supported config; a
    runtime signal — never a silent drop — otherwise (the debug-layer
    philosophy of main.cpp:379-390)."""
    overflow = jnp.zeros((), jnp.int32)

    if cfg.supersample > 1:
        import dataclasses as _dc

        s = cfg.supersample
        hi_cfg = _dc.replace(
            cfg, width=cfg.width * s, height=cfg.height * s, supersample=1
        )
        hi, st = render_stats(state, hi_cfg)
        hi = hi.astype(jnp.float32)
        lo = hi.reshape(cfg.height, s, cfg.width, s, 3).mean(axis=(1, 3))
        return jnp.round(lo).astype(jnp.uint8), st

    # Each stage runs under a named scope: a profiler trace attributes device
    # time to stages by these names (tools/profile_frame.py).
    with jax.named_scope("setup"):
        tris, view_proj = setup_frame_triangles(state, cfg)
    with jax.named_scope("raster"):
        frags, overflow = dispatch.rasterize(tris.packed, tris.aabb, cfg)
    if cfg.normal_mapping:
        from .ops.bump import apply_normal_mapping
        from .ops.lighting import reconstruct_world_positions

        with jax.named_scope("bump"):
            world = reconstruct_world_positions(frags.depth, view_proj, cfg)
            frags = apply_normal_mapping(
                frags, world, cfg.bump_strength, cfg.bump_frequency
            )
    with jax.named_scope("gbuffer"):
        gb = encode_gbuffer(frags, state.materials, cfg)

    if cfg.shading == "lambert":
        with jax.named_scope("shading"):
            color = shade_lambert(gb, state.lights, cfg)
        if cfg.fxaa:
            with jax.named_scope("post"):
                color = post.fxaa(color)
    else:
        vis = None
        if cfg.shadows:
            with jax.named_scope("shadow_map"):
                shadow_depth, light_vp, s_overflow = render_shadow_map(
                    state, cfg, return_overflow=True
                )
            with jax.named_scope("pcf"):
                vis, v_overflow = shadow_visibility(
                    gb.depth, view_proj, shadow_depth, light_vp, cfg,
                    return_overflow=True,
                )
            overflow = overflow + s_overflow + v_overflow
        with jax.named_scope("shading"):
            hdr, l_overflow = dispatch.shade_pbr(
                gb, state.lights, cfg, view_proj, state.camera.eye,
                shadow_visibility=vis,
            )
        overflow = overflow + l_overflow
        with jax.named_scope("post"):
            color = post.apply_post(hdr, cfg)

    with jax.named_scope("post"):
        return post.to_uint8(color), {"overflow": overflow}


def _warn_overflow(overflow):
    """Device-side overflow tripwire: prints (once per offending frame) when a
    tile dropped geometry/lights — the debug-layer analog of a D3D12 warning.
    Callers that need a hard signal use render_stats() and assert."""

    def warn():
        jax.debug.print(
            "[renderer] WARNING: per-tile capacity overflow on {n} tiles — "
            "triangles or lights were dropped this frame; raise "
            "max_tris_per_tile / max_lights_per_tile / bin_max_big.",
            n=overflow,
        )
        return 0

    jax.lax.cond(overflow > 0, warn, lambda: 0)


def render(state: SceneState, cfg: RendererConfig) -> jnp.ndarray:
    """Render one frame from scene state -> display-ready uint8 [H, W, 3].

    Emits a runtime warning print if any per-tile capacity overflowed (see
    render_stats for programmatic access to the count)."""
    frame, stats = render_stats(state, cfg)
    if cfg.overflow_warn:
        _warn_overflow(stats["overflow"])
    return frame


def render_gbuffer(state: SceneState, cfg: RendererConfig) -> GBuffer:
    """Geometry pass only (for tests/tools): G-buffer with format quantization."""
    tris, _ = setup_frame_triangles(state, cfg)
    frags, _ = dispatch.rasterize(tris.packed, tris.aabb, cfg)
    return encode_gbuffer(frags, state.materials, cfg)


def step_frame(
    state: SceneState, cfg: RendererConfig
) -> Tuple[SceneState, jnp.ndarray]:
    """One iteration of the reference's while-loop (main.cpp:161-342): advance the
    animation clock, render.  Jit this (static cfg) and loop on the host."""
    state = animate(state, cfg.yaw_per_frame, cfg)
    return state, render(state, cfg)


@functools.partial(jax.jit, static_argnums=(1,))
def step_frame_jit(state: SceneState, cfg: RendererConfig):
    return step_frame(state, cfg)


def render_batch(state: SceneState, cfg: RendererConfig, num_frames: int):
    """Render `num_frames` consecutive animated frames in ONE jitted program
    (BASELINE config 5 stretch: batch frames per jit step).  Returns
    (final_state, frames [N, H, W, 3] uint8)."""

    def body(st, _):
        st, frame = step_frame(st, cfg)
        return st, frame

    return jax.lax.scan(body, state, None, length=num_frames)
