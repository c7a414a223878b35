"""Measure the non-headline BASELINE configs on a GPU.

  config1   — 720p reference parity (cube+pyramid, Lambert)
  config4   — 1080p PBR + shadows + procedural bump + bloom
  colonnade — a second scene at the flagship config, budgets from autotune
  4k        — 3840x2160, 1024 lights, animated camera (stretch row), and the
              same with 8 frames per jit step

Each row times a chain of state-evolving frames that ends in a checksum read.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import d3d12_deferred_renderer_tpu as dxr
import d3d12_deferred_renderer_tpu.frame as fr
from d3d12_deferred_renderer_tpu.utils.debug import enable_compilation_cache

from bench import build, LIGHT_RADIUS  # noqa: E402


def timed_step(cfg, state, n=20, passes=3):
    @jax.jit
    def step(s):
        s2, frame = fr.step_frame(s, cfg)
        return s2, jnp.sum(frame.astype(jnp.uint32))

    s, ck = step(state)
    int(ck)
    # Best of `passes`: every pass computes every frame byte.
    dt = float("inf")
    for _ in range(passes):
        t0 = time.time()
        for _ in range(n):
            s, ck = step(s)
        int(ck)
        dt = min(dt, (time.time() - t0) / n)
    return dt


def report(name, cfg, state, n=20):
    _, stats = jax.jit(fr.render_stats, static_argnums=(1,))(state, cfg)
    overflow = int(stats["overflow"])
    dt = timed_step(cfg, state, n)
    print(
        f"{name}: {dt * 1e3:7.2f} ms/frame  {1.0 / dt:6.1f} FPS  "
        f"({cfg.width}x{cfg.height}, overflow={overflow})",
        flush=True,
    )


def main():
    enable_compilation_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {jax.default_backend()}")

    # config 1: reference parity.
    assets = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
    cfg1 = dxr.REFERENCE_CONFIG
    geo1 = dxr.build_scene_geometry([
        dxr.load_obj(os.path.join(assets, "cube.obj")),
        dxr.load_obj(os.path.join(assets, "pyramid.obj")),
    ])
    state1 = dxr.make_scene(geo1, cfg1)
    report("config1 720p lambert parity", cfg1, state1, n=60)

    # config 4: full feature stack.
    cfg4 = dataclasses.replace(
        dxr.FLAGSHIP_CONFIG, shadows=True, normal_mapping=True, bloom=True,
    )
    _, state4, _ = build(cfg4)
    # Light-view-calibrated shadow binning tiers (halves the shadow sort's
    # key array; calibrate.autotune_shadow docstring).
    from d3d12_deferred_renderer_tpu.calibrate import autotune_shadow

    cfg4, srep = autotune_shadow(state4, cfg4)
    print(f"shadow tiers {srep['tiers']} ({srep['sort_keys']} keys)")
    report("config4 1080p shadows+bump+bloom", cfg4, state4, n=30)

    # Second-scene row: the colonnade layout (a different footprint profile
    # — tall grazing-angle columns, far-plane orb line, bigger ground slab)
    # at the flagship config, with every scene-dependent budget derived by
    # calibrate.autotune; it must be overflow-free on content the flagship
    # budgets never saw.
    cfg_c = dxr.FLAGSHIP_CONFIG
    geo_c = dxr.build_scene_geometry(dxr.procedural.colonnade_meshes())
    lights_c = dxr.random_point_lights(256, cfg=cfg_c, radius=LIGHT_RADIUS)
    state_c = dxr.make_scene(
        geo_c, cfg_c, lights=lights_c, placement="origin",
        materials=dxr.Materials.varied(geo_c.num_meshes),
    )
    from d3d12_deferred_renderer_tpu.calibrate import autotune

    cfg_c, crep = autotune(state_c, cfg_c)
    print(
        f"colonnade autotune: ladder {crep['ladder']} budgets "
        f"{crep['budgets']} stream {crep['stream_cap']} "
        f"keys {crep['sort_keys']} pcf_cap {crep['shadow_tiles_cap']} "
        f"lights/tile {crep['max_lights_per_tile']}"
    )
    report("colonnade 1080p 256 lights autotuned", cfg_c, state_c, n=30)

    # 4K stretch: 1024 lights, animated camera flythrough (the BASELINE
    # stretch spec: orbiting eye + yawing meshes every frame).  Binning tier
    # budgets and the stream cap auto-scale with framebuffer area; the light
    # cap equals the light count, so culling never drops a light.
    cfg4k = dataclasses.replace(
        dxr.FLAGSHIP_CONFIG, width=3840, height=2160, animate_camera=True,
        max_lights_per_tile=1024,
    )
    _, state4k, _ = build(cfg4k, n_lights=1024)
    report("4k 1024 lights flythrough", cfg4k, state4k, n=20)

    # Same, 8 frames per jit step (BASELINE: "batch 8 frames per jit step");
    # per-frame device work is unchanged.
    report_batch("4k flythrough batch8", cfg4k, state4k, batch=8, n=3)


def report_batch(name, cfg, state, batch=8, n=3):
    @jax.jit
    def step(s):
        s2, frames = fr.render_batch(s, cfg, batch)
        return s2, jnp.sum(frames.astype(jnp.uint32))

    s, ck = step(state)
    int(ck)
    t0 = time.time()
    for _ in range(n):
        s, ck = step(s)
    int(ck)
    dt = (time.time() - t0) / (n * batch)
    print(
        f"{name}: {dt * 1e3:7.2f} ms/frame  {1.0 / dt:6.1f} FPS  "
        f"({cfg.width}x{cfg.height}, {batch} frames/jit step)",
        flush=True,
    )


if __name__ == "__main__":
    main()
