"""Probe: how many PCF gathers does each compaction grain actually need?

The sparse-PCF gather count is STATIC: cap x pixels-per-segment — the
compaction only helps through a smaller cap.  This measures, over the full
camera orbit of the config-4 benchmark scene (CPU; tools/_cpu_raster.py
AABB-box rasterizer — the full XLA oracle is O(T*H*W), hours at 1080p):

  - covered (8,128) tiles          (what shadow_tiles_cap=1216 was sized for)
  - lit-covered (8,128) tiles      (the dd59441 lit-facing prune's grain)
  - covered (1,128) sub-rows       (a finer compaction grain, /8 the pixels)
  - lit-covered (1,128) sub-rows

"lit" = any pixel with geometry AND NdotL > 0 for the directional light,
from the interpolated geometric normal (a mask from shading would additionally
sees the bump perturbation and unorm10 quantization — sign flips from those
are local and cannot empty/fill a whole 128-px segment; cap margins absorb
them, and the runtime overflow counter stays loud regardless).

Run: python tools/lit_tiles.py [--steps 16]
"""
from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles
from d3d12_deferred_renderer_tpu.scene import animate

from _cpu_raster import raster_depth_normal  # noqa: E402
from bench import build  # noqa: E402


def main():
    steps = 16
    if "--steps" in sys.argv:
        steps = int(sys.argv[sys.argv.index("--steps") + 1])
    cfg = dataclasses.replace(
        dxr.FLAGSHIP_CONFIG, use_pallas=False,
        shadows=True, normal_mapping=True, bloom=True,
    )
    _, state, _ = build(cfg)
    H, W = cfg.height, cfg.width

    setup = jax.jit(setup_frame_triangles, static_argnums=(1,))

    def seg_counts(mask, th):
        m = (
            mask.reshape(H // th, th, W // 128, 128)
            .transpose(0, 2, 1, 3).reshape(-1, th * 128)
        )
        return int(np.any(m, axis=1).sum())

    rows = []
    s = state
    for i in range(steps):
        s = animate(s, 2 * np.pi / steps, cfg)
        tris, vp = setup(s, cfg)
        packed = np.asarray(tris.packed)
        depth, normal, _ = raster_depth_normal(packed, H, W)
        ld = np.array(s.lights.direction, np.float32)
        ld = ld / np.linalg.norm(ld)
        geom = depth < 1.0
        lit = geom & ((-(normal @ ld)) > 0.0)
        rows.append((
            seg_counts(geom, 8), seg_counts(lit, 8),
            seg_counts(geom, 1), seg_counts(lit, 1),
        ))
        print(f"step {i}: {rows[-1]}", flush=True)
    a = np.array(rows)
    nt8 = (H // 8) * (W // 128)
    nt1 = H * (W // 128)
    names = ["covered tiles (8,128)", "lit tiles (8,128)",
             "covered rows (1,128)", "lit rows (1,128)"]
    tot = [nt8, nt8, nt1, nt1]
    print(f"orbit steps: {steps}")
    base = a[:, 0].max() * 1024
    for i, nm in enumerate(names):
        g = a[:, i].max() * (1024 if i < 2 else 128)
        print(f"{nm:>24}: max {a[:, i].max():6d} / {tot[i]} "
              f"(mean {a[:, i].mean():8.1f})  -> {g:8d} px gathers at cap "
              f"= {g / base:5.2f}x of tile-covered")


if __name__ == "__main__":
    main()
