#!/usr/bin/env python3
"""Smoke test of the renderer's main path on an NVIDIA GPU.

    python3 chip_smoke.py               # one card: phases 1-3
    python3 chip_smoke.py --four-cards  # four cards: the sharded phase only

Phases (each prints its measured values and its time):

1. Main path: the bench.py flagship scene (24 meshes, 23,906 triangles, 256
   point lights, 1920x1080, PBR with per-tile culling, FLAGSHIP_CONFIG)
   through runtime.App.run (frame.step_frame_jit + PresentQueue readback) for
   8 frames.  Overflow must be 0 on every frame; frames must not be black.
2. Oracle comparison: one flagship frame with the Triton kernels against the
   plain-XLA oracle (use_pallas=False), and the golden scenes of tests/golden
   with the kernels.  Bounds: mesh ids agree on >= 99.5% of pixels, depth
   |d| <= 1e-6 where they agree, final uint8 mean |d| <= 0.5 and <= 0.5% of
   pixels off by more than 4 (edge ties: Triton contracts FMAs unlike XLA).
3. Config-4 stack (shadows, normal mapping, bloom, FXAA) at 1080p against the
   oracle with the same bounds; overflow 0.
4. (--four-cards) the flagship frame through render_frames_batch_sharded on
   a (1 frame x 4 rows) mesh and render_frames_batch_tri_sharded on
   (1 x 2 tri x 2 rows), each held to the single-device render.

Exits non-zero, printing no result line, on any failure or when JAX finds no
GPU.  The last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Oracle-agreement bounds (module docstring, phase 2).
MESH_AGREE_MIN = 0.995
DEPTH_TOL = 1e-6
MEAN_U8_MAX = 0.5
FRAC_GT4_MAX = 0.005


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def frags_and_frame(state, cfg):
    """(FragmentPlanes, uint8 frame, overflow) of one frame of `state`."""
    import jax

    from d3d12_deferred_renderer_tpu import frame as fr
    from d3d12_deferred_renderer_tpu.ops import dispatch
    from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

    def run(s):
        tris, _ = setup_frame_triangles(s, cfg)
        frags, _ = dispatch.rasterize(tris.packed, tris.aabb, cfg)
        frame, stats = fr.render_stats(s, cfg)
        return frags, frame, stats["overflow"]

    frags, frame, ovf = jax.jit(run)(state)
    return jax.device_get(frags), np.asarray(frame), int(ovf)


def compare(name, got, want):
    """Hold kernel (frags, frame) to the oracle's; print and return stats."""
    (gf, gframe), (wf, wframe) = got, want
    agree = gf.mesh_id == wf.mesh_id
    mesh_agree = float(agree.mean())
    depth_d = float(np.abs(gf.depth - wf.depth)[agree].max(initial=0.0))
    d = np.abs(gframe.astype(np.int32) - wframe.astype(np.int32))
    mean_u8 = float(d.mean())
    frac_gt4 = float((d.max(axis=-1) > 4).mean())
    print(f"  {name}: mesh-id agree {mesh_agree:.6f}, depth max|d| {depth_d:.3g}, "
          f"u8 mean|d| {mean_u8:.4f}, frac>4 {frac_gt4:.6f}, max {int(d.max())}")
    check(mesh_agree >= MESH_AGREE_MIN, f"{name}: mesh ids agree on {mesh_agree}")
    check(depth_d <= DEPTH_TOL, f"{name}: depth differs by {depth_d}")
    check(mean_u8 <= MEAN_U8_MAX, f"{name}: mean u8 difference {mean_u8}")
    check(frac_gt4 <= FRAC_GT4_MAX, f"{name}: {frac_gt4} of pixels differ by >4")


def kernel_vs_oracle(name, state, cfg):
    kern = frags_and_frame(state, cfg)
    oracle = frags_and_frame(state, dataclasses.replace(cfg, use_pallas=False))
    print(f"  {name}: overflow kernel {kern[2]}, oracle {oracle[2]}")
    check(kern[2] == 0, f"{name}: kernel overflow {kern[2]}")
    compare(name, kern[:2], oracle[:2])


def phase_main_path(dxr, build):
    import jax

    from d3d12_deferred_renderer_tpu import frame as fr
    from d3d12_deferred_renderer_tpu.runtime.app import App

    cfg = dxr.FLAGSHIP_CONFIG
    _, state, geo = build(cfg)
    check(geo.num_triangles == 23906, f"flagship scene has {geo.num_triangles}")
    frames = []
    app = App(state, cfg, present_callback=lambda i, f: frames.append(f))
    overflow = jax.jit(lambda s: fr.render_stats(s, cfg)[1]["overflow"])
    ovf = []
    t0 = time.perf_counter()
    for _ in range(8):
        app.run(1)
        ovf.append(int(overflow(app.state)))
    dt = time.perf_counter() - t0
    check(len(frames) == 8, f"{len(frames)} frames presented")
    lit = [float((f.max(axis=-1) > 0).mean()) for f in frames]
    print(f"  8 frames {cfg.width}x{cfg.height}, {geo.num_triangles} triangles, "
          f"{state.lights.num_point} lights: max overflow {max(ovf)}, "
          f"lit share min {min(lit):.3f}, frame shape {frames[0].shape}")
    check(max(ovf) == 0, f"overflow {ovf}")
    check(all(f.shape == (1080, 1920, 3) and f.dtype == np.uint8 for f in frames),
          "frame shape/dtype")
    check(min(lit) > 0.1, "a frame is (nearly) black")
    return dt, state


def golden_scenes(dxr):
    """The scenes of tests/golden (test_frame.py), as (name, state, cfg)."""
    assets = os.path.join(ROOT, "assets", "models")
    cfg = dxr.RendererConfig(width=160, height=90)
    geo = dxr.build_scene_geometry([
        dxr.load_obj(os.path.join(assets, f"{m}.obj"), prefer_native=False)
        for m in ("cube", "pyramid")
    ])
    yield "reference_160x90_f10", dxr.make_scene(geo, cfg), cfg, 10
    cfg = dxr.RendererConfig(width=160, height=96, shading="pbr")
    geo = dxr.build_scene_geometry(
        dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16)
    )
    state = dxr.make_scene(
        geo, cfg, lights=dxr.random_point_lights(24, cfg=cfg), placement="grid",
        materials=dxr.Materials.varied(geo.num_meshes),
    )
    yield "pbr_160x96_f3", state, cfg, 3


def phase_oracle(dxr, state):
    from d3d12_deferred_renderer_tpu.utils import read_png

    t0 = time.perf_counter()
    kernel_vs_oracle("flagship", state, dxr.FLAGSHIP_CONFIG)
    for name, s, cfg, n in golden_scenes(dxr):
        for _ in range(n):  # the golden is the n-th frame of step_frame
            s = dxr.animate(s, cfg.yaw_per_frame, cfg)
        kern = frags_and_frame(s, cfg)
        oracle = frags_and_frame(s, dataclasses.replace(cfg, use_pallas=False))
        golden = read_png(os.path.join(ROOT, "tests", "golden", f"{name}.png"))
        compare(f"golden {name} vs oracle", kern[:2], oracle[:2])
        compare(f"golden {name} vs png", kern[:2], (oracle[0], golden))
    return time.perf_counter() - t0


def phase_config4(dxr, state):
    t0 = time.perf_counter()
    cfg = dataclasses.replace(
        dxr.FLAGSHIP_CONFIG, shadows=True, normal_mapping=True, bloom=True,
        fxaa=True,
    )
    kernel_vs_oracle("config4", state, cfg)
    return time.perf_counter() - t0


def phase_four_cards(dxr, build):
    import jax

    from d3d12_deferred_renderer_tpu.parallel import dryrun, make_mesh
    from d3d12_deferred_renderer_tpu.parallel.sharded import (
        animation_times,
        render_frames_batch_sharded,
        render_frames_batch_tri_sharded,
    )

    devices = jax.devices()
    check(len(devices) == 4, f"{len(devices)} devices, --four-cards needs 4")
    cfg = dxr.FLAGSHIP_CONFIG
    _, state, _ = build(cfg)
    times = animation_times(0.0, 1)
    t0 = time.perf_counter()
    runs = (
        ("1 frame x 4 rows", make_mesh((1, 4), ("frame", "rows"), devices=devices),
         lambda m: render_frames_batch_sharded(state, times, cfg, m,
                                               return_stats=True)),
        ("1 frame x 2 tri x 2 rows",
         make_mesh((1, 2, 2), ("frame", "tri", "rows"), devices=devices),
         lambda m: render_frames_batch_tri_sharded(
             state, times, cfg, m, rows_axis="rows", return_stats=True)),
    )
    for name, mesh, render in runs:
        frames, stats = render(mesh)
        frames.block_until_ready()
        placed = {s.device for s in frames.addressable_shards}
        print(f"  {name}: output on {len(placed)} devices, "
              f"overflow {int(stats['overflow'])}")
        check(len(placed) == 4, f"{name}: output placed on {placed}")
        check(int(stats["overflow"]) == 0, f"{name}: overflow")
        dryrun.assert_matches_single_device(frames, state, cfg, 1, name)
        print(f"  {name}: matches the single-device frame (<= 1 LSB)")
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="renderer smoke test on GPUs")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import d3d12_deferred_renderer_tpu as dxr
        from bench import build
    except ImportError as e:
        print(f"chip_smoke: the renderer is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import jax

    from d3d12_deferred_renderer_tpu.utils.debug import enable_compilation_cache

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {backend!r}", file=sys.stderr)
        return 1
    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = jax.devices()[0]
    print(smi)
    print(f"device_kind {dev.device_kind}, jax {jax.__version__}, "
          f"XLA_FLAGS {os.environ.get('XLA_FLAGS', '')!r}, compile cache {cache}")
    try:
        if args.four_cards:
            dt = phase_four_cards(dxr, build)
            print(f"phase four-cards ok in {dt:.1f} s")
        else:
            dt, state = phase_main_path(dxr, build)
            print(f"phase main-path ok in {dt:.1f} s")
            print(f"phase oracle ok in {phase_oracle(dxr, state):.1f} s")
            print(f"phase config4 ok in {phase_config4(dxr, state):.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
