"""Render demo frames to PNG — the visual smoke test.

Usage:
    python tools/demo.py [--scene reference|benchmark] [--frames 60] [--out /tmp/frames]
                         [--width 1280] [--height 720] [--shading lambert|pbr]
                         [--lights N] [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="reference", choices=["reference", "benchmark"])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="/tmp/frames")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--shading", default="lambert", choices=["lambert", "pbr"])
    ap.add_argument("--lights", type=int, default=0)
    ap.add_argument("--bloom", action="store_true")
    ap.add_argument("--fxaa", action="store_true")
    ap.add_argument("--shadows", action="store_true")
    ap.add_argument("--shadow-map-size", type=int, default=None,
                    help="shadow map resolution (default: RendererConfig's "
                    "1024; smaller keeps the CPU oracle path tractable)")
    ap.add_argument("--bump", action="store_true", help="procedural normal mapping")
    ap.add_argument("--orbit", action="store_true", help="camera flythrough")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--light-dir", default=None,
                    help="directional light as 'x,y,z' (default: reference)")
    ap.add_argument("--materials", default="reference",
                    choices=["reference", "varied"],
                    help="per-mesh material set (reference red or varied)")
    ap.add_argument("--sun", type=float, default=1.0,
                    help="directional light intensity multiplier")
    ap.add_argument("--ambient", type=float, default=None,
                    help="ambient level (default: RendererConfig.ambient)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from d3d12_deferred_renderer_tpu.utils.debug import enable_compilation_cache

    enable_compilation_cache()

    import d3d12_deferred_renderer_tpu as dxr
    from d3d12_deferred_renderer_tpu.runtime import App
    from d3d12_deferred_renderer_tpu.runtime.app import save_frames_to_dir

    light_kw = {}
    if args.light_dir:
        light_kw["light_direction"] = tuple(
            float(t) for t in args.light_dir.split(",")
        )
    if args.sun != 1.0:
        light_kw["light_color"] = (args.sun, args.sun, args.sun)
    if args.ambient is not None:
        light_kw["ambient"] = args.ambient
    cfg = dxr.RendererConfig(
        width=args.width,
        height=args.height,
        shading=args.shading,
        bloom=args.bloom,
        fxaa=args.fxaa,
        shadows=args.shadows,
        **({"shadow_map_size": args.shadow_map_size}
           if args.shadow_map_size else {}),
        normal_mapping=args.bump,
        animate_camera=args.orbit,
        **light_kw,
        # Benchmark-scene densities exceed the reference-parity defaults; size
        # the per-tile caps like FLAGSHIP_CONFIG so nothing overflows (the
        # render_stats check below would flag it loudly otherwise).
        **(
            {"max_tris_per_tile": 1024,
             "max_lights_per_tile": max(args.lights, 64)}
            if args.scene == "benchmark" else {}
        ),
    )

    assets = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
    if args.scene == "reference":
        meshes = [
            dxr.load_obj(os.path.join(assets, "cube.obj")),
            dxr.load_obj(os.path.join(assets, "pyramid.obj")),
        ]
        placement = "reference"
    else:
        meshes = dxr.procedural.benchmark_meshes(n=24)
        placement = "grid"

    geo = dxr.build_scene_geometry(meshes)
    lights = (
        dxr.random_point_lights(args.lights, cfg=cfg) if args.lights else None
    )
    materials = (
        dxr.Materials.varied(geo.num_meshes)
        if args.materials == "varied" else None
    )
    state = dxr.make_scene(
        geo, cfg, lights=lights, placement=placement, materials=materials
    )

    # No-silent-drop check.
    import jax.numpy as jnp  # noqa: F401
    from d3d12_deferred_renderer_tpu import frame as fr

    _, _stats = jax.jit(fr.render_stats, static_argnums=(1,))(state, cfg)
    overflow = int(_stats["overflow"])
    if overflow:
        print(f"WARNING: per-tile capacity overflow on {overflow} tiles — "
              "geometry/lights dropped; raise the caps in RendererConfig")

    app = App(state, cfg, present_callback=save_frames_to_dir(args.out))
    stats = app.run(args.frames)
    print(
        f"rendered {stats.frames} frames at {args.width}x{args.height} "
        f"-> {args.out} ({stats.fps:.1f} FPS incl. compile)"
    )


if __name__ == "__main__":
    main()
