"""Auto-calibrate scene-dependent capacity budgets and verify them.

  python tools/calibrate.py [--scene benchmark|colonnade] [--margin 0.3]
                            [--samples 24] [--verify 24] [--config4]

Runs calibrate.autotune over the full yaw orbit, prints the derived config
diff, then re-renders `--verify` orbit samples with the calibrated config and
asserts overflow == 0 on every one (the loud-overflow contract holds with the
derived margins).  See d3d12_deferred_renderer_tpu/calibrate.py.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu import frame as fr
from d3d12_deferred_renderer_tpu.calibrate import autotune
from d3d12_deferred_renderer_tpu.utils.debug import enable_compilation_cache

from bench import build, LIGHT_RADIUS  # noqa: E402


def make_state(scene, cfg, n_lights=256):
    if scene == "benchmark":
        _, state, _ = build(cfg, n_lights=n_lights)
        return state
    if scene == "colonnade":
        meshes = dxr.procedural.colonnade_meshes()
        geo = dxr.build_scene_geometry(meshes)
        lights = dxr.random_point_lights(n_lights, cfg=cfg, radius=LIGHT_RADIUS)
        return dxr.make_scene(
            geo, cfg, lights=lights, placement="origin",
            materials=dxr.Materials.varied(geo.num_meshes),
        )
    raise SystemExit(f"unknown scene {scene!r}")


def main():
    enable_compilation_cache()
    args = sys.argv[1:]

    def opt(name, default, cast=str):
        return cast(args[args.index(name) + 1]) if name in args else default

    scene = opt("--scene", "benchmark")
    margin = opt("--margin", 0.3, float)
    samples = opt("--samples", 24, int)
    n_verify = opt("--verify", 24, int)

    cfg = dxr.FLAGSHIP_CONFIG
    if "--config4" in args:
        cfg = dataclasses.replace(
            cfg, shadows=True, normal_mapping=True, bloom=True,
        )
    state = make_state(scene, cfg)

    cal, report = autotune(state, cfg, yaw_steps=samples, margin=margin)
    print(json.dumps(report, default=int))
    for f in (
        "bin_expand", "bin_expand_medium", "bin_expand_large",
        "bin_max_small", "bin_max_medium", "bin_max_large", "bin_max_big",
        "bin_stream_cap", "max_tris_per_tile", "shadow_tiles_cap",
        "max_lights_per_tile",
    ):
        a, b = getattr(cfg, f), getattr(cal, f)
        mark = "  " if a == b else "->"
        print(f"  {f:>26}: {a:>7} {mark} {b}")

    # Verify: a full orbit with the calibrated config must be overflow-free.
    step = jax.jit(fr.render_stats, static_argnums=(1,))
    s = state
    worst = 0
    for i in range(n_verify):
        s = fr.animate(s, 2.0 * np.pi / n_verify, cal)
        _, stats = step(s, cal)
        worst = max(worst, int(stats["overflow"]))
    print(f"verify: {n_verify} orbit samples, overflow max = {worst}")
    assert worst == 0, "calibrated config overflowed — raise --margin"


if __name__ == "__main__":
    main()
