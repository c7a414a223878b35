"""Roofline model: how far is each frame stage from the card's floor?

For every stage of the flagship (or --config4 / --w4k) frame this prints the
analytically counted device-memory bytes and float32 FLOPs, and the floor
they imply at the card's published peaks.  With --times (per-stage device
milliseconds from tools/profile_frame.py) it adds each stage's share of
its floor and which resource bounds it.

Peaks come from PEAKS, keyed by JAX's device_kind (--device; an unknown
device is an error, not a default).  FLOP counts are per-operation estimates
of the emitted elementwise sequence (annotated inline, good to ~2x), enough
to separate "bandwidth-bound" from "nowhere near any floor".

Scene-dependent work sizes (live records, binned pairs, per-tile live-light
sums, covered tiles) are measured from the actual benchmark scene on the CPU.

Usage:
  python tools/roofline.py [--config4] [--w4k] [--device KIND]
                           [--times ms,ms,...]
"""
from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.transform import (
    TRI_STRIDE, TRI_VALID, setup_frame_triangles,
)
from d3d12_deferred_renderer_tpu.scene import animate

# Published dense peaks per device_kind (NVIDIA H100 SXM data sheet, at the
# 700 W power limit): device memory GB/s and float32 (non-tensor-core)
# TFLOP/s.  The frame's arithmetic is elementwise float32.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "fp32_tflops": 67.0},
}


def peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise ValueError(
            f"no peak table for device {device_kind!r}; add it to PEAKS"
        )
    return PEAKS[device_kind]


# --- per-unit FLOP estimates (annotated; ~2x accuracy) ---
F_SETUP_PER_RECORD = 260   # 3 verts x (4x4 MVP mul 28 + divide 6) + cull/pack ~60
F_RASTER_PER_PAIRPX = 30   # 3 edge fns + z/rw interp + 5 attrs + depth test
F_GGX_PER_PXLIGHT = 110    # dist/falloff 20, NdotL/H 25, D+G+F (pow5) 40, acc 25
F_RESOLVE_PER_PX = 150     # decode + world + directional GGX + ambient
F_POST_PER_PX = 40         # reinhard + gamma pow + u8
F_BUMP_PER_PX = 80         # analytic height-field derivatives + TBN perturb
F_PCF_FILTER_PER_PX = 40   # bilinear weights + 4 compares + blend
SHADE_TILE = 32            # ops/lighting_pallas.TILE


def measure_scene(cfg, yaw_samples=4):
    """CPU-measured per-frame work sizes, maxed over orbit samples.

    Depth comes from tools/_cpu_raster.py's AABB-box rasterizer (the XLA
    oracle is O(T*H*W) — hours at 1080p on CPU); footprints/pair counts use
    the same AABB->tile-rect math as calibrate._measure_frame."""
    from d3d12_deferred_renderer_tpu.ops.lighting import cull_lights_to_tiles
    from d3d12_deferred_renderer_tpu.ops.transform import TRI_VALID

    from _cpu_raster import raster_depth_normal
    from bench import build

    cpu_cfg = dataclasses.replace(cfg, use_pallas=False)
    _, state, _ = build(cpu_cfg)
    H, W = cfg.height, cfg.width
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    setup = jax.jit(setup_frame_triangles, static_argnums=(1,))
    out = dict(T=0, live=0, pairs=0, covered=0, light_entries=0)
    s = state
    for _ in range(yaw_samples):
        s = animate(s, 2 * np.pi / yaw_samples, cpu_cfg)
        tris, vp = setup(s, cpu_cfg)
        packed = np.asarray(tris.packed)
        aabb = np.asarray(tris.aabb)
        valid = packed[:, TRI_VALID] > 0
        tx0 = np.floor(aabb[:, 0] / TW).astype(np.int64)
        ty0 = np.floor(aabb[:, 1] / TH).astype(np.int64)
        tx1 = np.floor(aabb[:, 2] / TW).astype(np.int64)
        ty1 = np.floor(aabb[:, 3] / TH).astype(np.int64)
        live = valid & (tx1 >= 0) & (tx0 < ntx) & (ty1 >= 0) & (ty0 < nty)
        w = np.clip(tx1, 0, ntx - 1) - np.clip(tx0, 0, ntx - 1) + 1
        h = np.clip(ty1, 0, nty - 1) - np.clip(ty0, 0, nty - 1) + 1
        out["T"] = packed.shape[0]
        out["live"] = max(out["live"], int(live.sum()))
        out["pairs"] = max(out["pairs"], int((w * h)[live].sum()))
        depth, _, _ = raster_depth_normal(packed, H, W)
        d_t = (
            depth.reshape(nty, TH, ntx, TW).transpose(0, 2, 1, 3)
            .reshape(-1, TH * TW)
        )
        out["covered"] = max(out["covered"],
                             int((d_t.min(axis=1) < 1.0).sum()))
        tl = cull_lights_to_tiles(
            jnp.asarray(depth), s.lights, cpu_cfg, vp, tile=SHADE_TILE,
            max_per_tile=s.lights.num_point,
        )
        out["light_entries"] = max(out["light_entries"],
                                   int(jnp.sum(tl.counts)))
    return out


def static_sort_keys(cfg):
    """The STATIC sort-key array length bin_triangles emits (sorting cost
    scales with this, not with live counts — static shapes)."""
    H, W = cfg.height, cfg.width
    nt = (-(-H // cfg.tile_h)) * (-(-W // cfg.tile_w))
    scale = max(1, round((H * W) / (1920 * 1080)))
    e, em, el = (cfg.bin_expand * scale, cfg.bin_expand_medium * scale,
                 cfg.bin_expand_large * scale)
    ls = cfg.bin_max_small * scale if cfg.bin_max_small > 0 else None
    keys = (ls if ls is not None else 0) * e \
        + cfg.bin_max_medium * scale * em \
        + cfg.bin_max_large * scale * el
    if el < nt:
        keys += cfg.bin_max_big * scale * nt
    return keys, nt


def build_model(cfg, m):
    """[(stage, bytes, flops, note)] for one frame at `cfg` (staged path:
    XLA setup and binning, Triton raster and shading kernels, XLA post)."""
    H, W = cfg.height, cfg.width
    px = H * W
    keys, nt = static_sort_keys(cfg)
    T, live, pairs = m["T"], m["live"], m["pairs"]
    covered_px = m["covered"] * cfg.tile_h * cfg.tile_w
    rec_b = TRI_STRIDE * 4
    tile_px = cfg.tile_h * cfg.tile_w

    stages = []
    # setup: fv column buffers in (3 verts x 8 f32 attrs), packed+aabb out.
    stages.append((
        "setup", T * (3 * 8 + TRI_STRIDE + 4) * 4, live * F_SETUP_PER_RECORD,
        f"T={T} records ({live} live)",
    ))
    # binning: key emit + one int32 sort of the static array + stream row
    # gather; sort traffic modeled as ~log2(n) read+write passes.
    lg = max(1, int(np.ceil(np.log2(max(keys, 2)))))
    stages.append((
        "binning", keys * 8 + keys * 8 * 2 * lg + pairs * 2 * rec_b, keys * 8,
        f"{keys} static keys, {pairs} pairs",
    ))
    # raster kernel: each tile program reads its records, writes 7 planes.
    stages.append((
        "raster", pairs * rec_b + px * 7 * 4,
        pairs * tile_px * F_RASTER_PER_PAIRPX,
        f"{pairs} (tile, triangle) pairs x {tile_px} px",
    ))
    stages.append((
        "gbuffer", px * (7 * 4 + 9 * 4), px * 40, "planes in, G-buffer out",
    ))
    if cfg.normal_mapping:
        stages.append((
            "bump", px * 10 * 4, covered_px * F_BUMP_PER_PX, "XLA block path",
        ))
    if cfg.shadows:
        S = cfg.shadow_map_size
        stages.append((
            "shadow_map", keys * 8 + pairs * rec_b + S * S * 4,
            live * F_SETUP_PER_RECORD + pairs * tile_px * F_RASTER_PER_PAIRPX,
            f"{S}x{S} depth",
        ))
        pcf_tiles = cfg.shadow_tiles_cap if cfg.shadow_tiles_cap > 0 else nt
        pcf_px = pcf_tiles * 8 * 128
        stages.append((
            "pcf", pcf_px * (32 + 4 + 4), pcf_px * F_PCF_FILTER_PER_PX,
            f"{pcf_tiles} covered tiles",
        ))
    # shading kernel: G-buffer + depth (+ vis) in, linear HDR out.
    light_flops = m["light_entries"] * SHADE_TILE ** 2 * F_GGX_PER_PXLIGHT
    stages.append((
        "shading", px * (9 + (1 if cfg.shadows else 0) + 3) * 4,
        light_flops + px * F_RESOLVE_PER_PX,
        f"{m['light_entries']} tile-light entries",
    ))
    stages.append((
        "post", px * (3 * 4 + 3) * (4 if cfg.bloom else 1),
        px * F_POST_PER_PX * (4 if cfg.bloom else 1), "tonemap/gamma/u8",
    ))
    return stages


def report(stages, pk, times_ms=None):
    gbps, tflops = pk["hbm_gbps"], pk["fp32_tflops"]
    print(f"{'stage':>10} {'MB':>8} {'mem us':>8} {'GFLOP':>7} {'flop us':>8}"
          + ("  measured  bound" if times_ms else ""))
    for i, (name, b, f, note) in enumerate(stages):
        mem_us = b / (gbps * 1e3)
        flop_us = f / (tflops * 1e6)
        row = (f"{name:>10} {b / 1e6:8.1f} {mem_us:8.1f} {f / 1e9:7.2f} "
               f"{flop_us:8.1f}")
        if times_ms:
            t_us = times_ms[i] * 1e3
            floor = max(mem_us, flop_us)
            which = "memory" if mem_us >= flop_us else "fp32"
            row += f"  {times_ms[i]:7.3f}ms  {which} {floor / t_us:6.1%} of floor"
        print(row + f"   | {note}")


def main():
    config4 = "--config4" in sys.argv
    cfg = dxr.FLAGSHIP_CONFIG
    if config4:
        cfg = dataclasses.replace(
            cfg, shadows=True, normal_mapping=True, bloom=True, fxaa=True
        )
    if "--w4k" in sys.argv:
        cfg = dataclasses.replace(cfg, width=3840, height=2160)
    kind = "NVIDIA H100 80GB HBM3"
    if "--device" in sys.argv:
        kind = sys.argv[sys.argv.index("--device") + 1]
    pk = peaks(kind)

    jax.config.update("jax_platforms", "cpu")  # scene stats are CPU work
    m = measure_scene(cfg)
    stages = build_model(cfg, m)

    times = None
    if "--times" in sys.argv:  # comma-separated per-stage device ms
        times = [float(x) for x in
                 sys.argv[sys.argv.index("--times") + 1].split(",")]
        if len(times) != len(stages):
            raise SystemExit(f"need {len(stages)} times: {[s[0] for s in stages]}")
    print(f"peaks for {kind}: {pk}")
    report(stages, pk, times)


if __name__ == "__main__":
    main()
