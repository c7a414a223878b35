"""Benchmark harness: 1080p deferred frame, multi-mesh scene, 256 point lights,
per-tile light culling (BASELINE.json config 3) on one NVIDIA GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
vs_baseline is FPS / 60 — the reference publishes no numbers (BASELINE.md), so
the >60 FPS target is the baseline.  Fails (exit 1, no line) without a GPU.

Timing: frames chain through the scene state and every timed step returns a
checksum over every frame byte; the loop ends in one checksum read, so the
time covers every frame computed.  Light radius is sized so per-tile culled
counts are realistic; the culling structures report `overflow`, so no light is
ever silently dropped.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

LIGHT_RADIUS = 1.2


def build(cfg, n_meshes=24, n_lights=256):
    import d3d12_deferred_renderer_tpu as dxr

    meshes = dxr.procedural.benchmark_meshes(n=n_meshes)
    geo = dxr.build_scene_geometry(meshes)
    lights = dxr.random_point_lights(n_lights, cfg=cfg, radius=LIGHT_RADIUS)
    state = dxr.make_scene(
        geo, cfg, lights=lights, placement="grid",
        materials=dxr.Materials.varied(geo.num_meshes),
    )
    return dxr, state, geo


def main():
    import d3d12_deferred_renderer_tpu as dxr
    import d3d12_deferred_renderer_tpu.frame as fr
    from d3d12_deferred_renderer_tpu.utils.debug import enable_compilation_cache

    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU, JAX found {jax.default_backend()}",
              file=sys.stderr)
        return 1
    enable_compilation_cache()
    cfg = dxr.FLAGSHIP_CONFIG
    dxr, state, geo = build(cfg)

    @jax.jit
    def step_ck(s, yaw, ovf):
        s2 = fr.animate(s, yaw, cfg)
        frame, stats = fr.render_stats(s2, cfg)
        # The checksum forces every frame byte; the carried overflow max
        # covers every timed frame.
        return s2, jnp.sum(frame.astype(jnp.uint32)), jnp.maximum(ovf, stats["overflow"])

    yaw = jnp.float32(cfg.yaw_per_frame)
    ovf = jnp.zeros((), jnp.int32)
    state, ck, ovf = step_ck(state, yaw, ovf)
    int(ck)

    # Full-orbit overflow sweep: the capacity budgets are claimed for the
    # whole yaw orbit, so stride 2*pi in 64 steps through the same compiled
    # program and fold the max into the gate.
    sweep_state = state
    for _ in range(64):
        sweep_state, ck, ovf = step_ck(
            sweep_state, jnp.float32(2.0 * np.pi / 64.0), ovf
        )
    int(ck)

    n, passes = 30, 3
    dt = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(n):
            state, ck, ovf = step_ck(state, yaw, ovf)
        int(ck)
        dt = min(dt, (time.perf_counter() - t0) / n)
    fps = 1.0 / dt
    overflow = int(ovf)

    # Kernel-vs-oracle check on a small frame on the same device: the Triton
    # kernels against the plain-XLA oracle (use_pallas=False).
    # The small frame packs the scene into 16 tiles, so it needs a deeper
    # per-tile triangle cap than the flagship's to drop nothing.
    pcfg = dataclasses.replace(cfg, width=256, height=64, max_tris_per_tile=4096)
    _, pstate, _ = build(pcfg, n_meshes=4, n_lights=16)
    kern, pstats = jax.jit(fr.render_stats, static_argnums=(1,))(pstate, pcfg)
    oracle = jax.jit(fr.render, static_argnums=(1,))(
        pstate, dataclasses.replace(pcfg, use_pallas=False)
    )
    d = jnp.abs(kern.astype(jnp.int32) - oracle.astype(jnp.int32)).max(axis=-1)
    parity = {
        "mean_abs_u8": float(jnp.mean(d)),
        "frac_gt_4lsb": float(jnp.mean(d > 4)),
        "max_u8": int(jnp.max(d)),
    }
    parity_ok = (
        parity["mean_abs_u8"] <= 0.5 and parity["frac_gt_4lsb"] <= 0.005
        and overflow == 0 and int(pstats["overflow"]) == 0
    )
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    result = {
        "metric": "1080p_fps_256_lights",
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": fps / 60.0,
        "detail": {
            "resolution": f"{cfg.width}x{cfg.height}",
            "lights": state.lights.num_point,
            "light_radius": LIGHT_RADIUS,
            "triangles": geo.num_triangles,
            "ms_per_frame": dt * 1e3,
            "timing": "checksum-forced chain, best of 3 passes of 30 frames",
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "overflow": overflow,
            "parity_ok": parity_ok,
            "parity_stats": parity,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
