"""Scene-budget auto-calibration.

Every capacity cap in RendererConfig (binning tier budgets, record-stream cap,
per-tile triangle cap, sparse-PCF tile cap, per-tile light-list depth) trades
memory traffic / sort keys against headroom, and the right value depends on the scene
and camera path.  FLAGSHIP_CONFIG's round-3 values were derived by hand from
orbit sweeps of the benchmark scene (config.py:268-289); this module automates
exactly that procedure for ANY scene so the perf contract doesn't collapse to
"retune by hand" on new content:

  calibrated_cfg, report = autotune(state, cfg, yaw_steps=24, margin=0.3)

sweeps the full 2*pi animation orbit, measures per-frame maxima of each
capacity, picks the binning tier ladder (footprint thresholds) minimizing the
total emitted sort keys, and returns a config whose budgets carry `margin`
headroom over the measured maxima.  Every derived cap still overflows LOUDLY
at runtime (the no-silent-drop contract is unchanged); calibration just makes
the margins principled.

The reference has no analog (all constants are compile-time, main.cpp); this
is infrastructure the design needs because static shapes are part of the
compiled program.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import RendererConfig
from .scene import SceneState, animate


# Candidate tier ladders (bin_expand, bin_expand_medium, bin_expand_large).
# The structure is fixed (four tiers, rect expansions); the ladder choice and
# the per-tier budgets are what calibration derives.
_LADDERS: Tuple[Tuple[int, int, int], ...] = (
    (2, 8, 64),      # FLAGSHIP_CONFIG's hand-tuned ladder
    (4, 32, 256),    # the untuned default
    (2, 16, 128),
    (4, 16, 96),
    (2, 8, 128),
    (4, 8, 64),
)


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def _measure_frame(state: SceneState, cfg: RendererConfig):
    """One orbit sample's capacity-relevant observables (device side).

    Returns (footprint [T] int32 tile-rect areas with 0 = not live,
    tile_counts [NT], total_pairs scalar, covered_tiles scalar,
    light_counts_max scalar)."""
    from .ops.transform import TRI_VALID, setup_frame_triangles

    tris, vp = setup_frame_triangles(state, cfg)
    packed, aabb = tris.packed, tris.aabb
    valid = packed[:, TRI_VALID] > 0

    H, W = cfg.height, cfg.width
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)

    minx, miny, maxx, maxy = aabb[:, 0], aabb[:, 1], aabb[:, 2], aabb[:, 3]
    tx0 = jnp.floor(minx / TW).astype(jnp.int32)
    tx1 = jnp.floor(maxx / TW).astype(jnp.int32)
    ty0 = jnp.floor(miny / TH).astype(jnp.int32)
    ty1 = jnp.floor(maxy / TH).astype(jnp.int32)
    live = valid & (tx1 >= 0) & (tx0 < ntx) & (ty1 >= 0) & (ty0 < nty)
    tx0c = jnp.clip(tx0, 0, ntx - 1)
    tx1c = jnp.clip(tx1, 0, ntx - 1)
    ty0c = jnp.clip(ty0, 0, nty - 1)
    ty1c = jnp.clip(ty1, 0, nty - 1)
    w = tx1c - tx0c + 1
    h = ty1c - ty0c + 1
    footprint = jnp.where(live, w * h, 0).astype(jnp.int32)

    # True per-tile counts via a 2D difference grid (+1/-1 at rect corners,
    # double cumsum) — O(T + NT) and cap-free, instead of binning with every
    # cap maxed out (a dense [NT, T] id layout would be ~hundreds of MB).
    # Same binning criterion as bin_triangles; counts are ladder-independent.
    one = live.astype(jnp.int32)
    grid = jnp.zeros((nty + 1, ntx + 1), jnp.int32)
    grid = grid.at[ty0c, tx0c].add(one)
    grid = grid.at[ty0c, tx1c + 1].add(-one)
    grid = grid.at[ty1c + 1, tx0c].add(-one)
    grid = grid.at[ty1c + 1, tx1c + 1].add(one)
    tile_counts = jnp.cumsum(jnp.cumsum(grid, axis=0), axis=1)[
        :nty, :ntx
    ].reshape(-1)
    total_pairs = jnp.sum(tile_counts)

    # Covered (8, 128) screen tiles for the sparse-PCF cap, and live lights
    # per light-cull tile for the light-list depth — both need the frame depth.
    from .ops import dispatch
    from .ops.lighting import cull_lights_to_tiles
    from .ops.lighting_pallas import TILE

    depth, _ = dispatch.rasterize_depth(packed, aabb, cfg)
    d_t = (
        depth.reshape(H // 8, 8, W // 128, 128).transpose(0, 2, 1, 3)
        .reshape(-1, 8 * 128)
        if H % 8 == 0 and W % 128 == 0
        else depth.reshape(1, -1)
    )
    covered = jnp.sum((d_t.min(axis=1) < 1.0).astype(jnp.int32))

    L = state.lights.num_point
    if L:
        tl = cull_lights_to_tiles(
            depth, state.lights, cfg, vp, tile=TILE, max_per_tile=L
        )
        light_max = jnp.max(tl.counts)
    else:
        light_max = jnp.zeros((), jnp.int32)

    return footprint, tile_counts, total_pairs, covered, light_max


def autotune(
    state: SceneState,
    cfg: RendererConfig,
    yaw_steps: int = 24,
    margin: float = 0.3,
):
    """Sweep the full 2*pi yaw orbit in `yaw_steps` samples and derive every
    scene-dependent capacity with `margin` headroom.  Returns
    (calibrated RendererConfig, report dict).

    The derived budgets only bind on the sort-based binning path (small scenes
    use the flat overlap matrix, which has no tier budgets); the stream cap,
    triangle cap, PCF tile cap, and light-list depth bind on every path."""
    meas = jax.jit(_measure_frame, static_argnums=(1,))

    k_max = 0
    pairs_max = 0
    covered_max = 0
    lights_max = 0
    _fps = []  # per-frame footprint arrays, for tier-ladder evaluation
    s = state
    for _ in range(yaw_steps):
        s = animate(s, 2.0 * np.pi / yaw_steps, cfg)
        fp, counts, pairs, covered, lmax = jax.device_get(meas(s, cfg))
        k_max = max(k_max, int(counts.max()))
        pairs_max = max(pairs_max, int(pairs))
        covered_max = max(covered_max, int(covered))
        lights_max = max(lights_max, int(lmax))
        _fps.append(np.asarray(fp))

    T = _fps[0].shape[0]
    H, W = cfg.height, cfg.width
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    NT = nty * ntx
    area_scale = max(1, round((H * W) / (1920 * 1080)))

    def bucket_maxima(e, em, el):
        """Per-frame maxima of each tier's occupancy for a ladder (scaled
        thresholds, like bin_triangles applies at runtime)."""
        E, EM, EL = e * area_scale, em * area_scale, el * area_scale
        ns = nm = nl = nb = 0
        for fp in _fps:
            live = fp > 0
            ns = max(ns, int((live & (fp <= E)).sum()))
            nm = max(nm, int((live & (fp > E) & (fp <= EM)).sum()))
            if EL < NT:
                nl = max(nl, int((live & (fp > EM) & (fp <= EL)).sum()))
                nb = max(nb, int((live & (fp > EL)).sum()))
            else:
                nl = max(nl, int((live & (fp > EM)).sum()))
        return ns, nm, nl, nb

    best = None
    for e, em, el in _LADDERS:
        ns, nm, nl, nb = bucket_maxima(e, em, el)
        # Budgets with margin, aligned like the runtime expects (the small
        # tier compaction uses 128-row alignment; the rest 8).  bin_triangles
        # multiplies every tier budget (and the stream cap) by area_scale at
        # runtime, so the config stores 1080p-equivalent units: divide the
        # measured occupancy by the scale this calibration ran at (the
        # margin absorbs the tile-boundary leakage between scaled buckets).
        LS = min(_round_up(ns * (1 + margin) / area_scale + 1, 128), T)
        MB = min(_round_up(nm * (1 + margin) / area_scale + 1, 8), T)
        ML = min(_round_up(nl * (1 + margin) / area_scale + 1, 8), T)
        BB = min(max(_round_up(nb * (1 + margin) / area_scale + 1, 8), 8), T)
        E, EM, EL = e * area_scale, em * area_scale, el * area_scale
        has_big = EL < NT
        keys = (
            LS * E + MB * EM + ML * EL + (BB * NT if has_big else 0)
        ) * area_scale
        cand = (keys, (e, em, el), (LS, MB, ML, BB))
        if best is None or cand[0] < best[0]:
            best = cand

    keys, (e, em, el), (LS, MB, ML, BB) = best
    stream_cap = min(
        _round_up(pairs_max * (1 + margin) / area_scale, 1024),
        -(-int(keys) // area_scale),  # can't exceed the emitted key count
    )
    k_cap = min(_round_up(k_max * (1 + margin), 8), T)
    pcf_cap = min(_round_up(covered_max * (1 + margin), 8), NT)
    # Per-tile light-list depth.
    L = state.lights.num_point
    light_cap = min(_round_up(max(lights_max, 1) * (1 + margin), 16), max(L, 1))

    out = dataclasses.replace(
        cfg,
        bin_expand=e,
        bin_expand_medium=em,
        bin_expand_large=el,
        bin_max_small=LS,
        bin_max_medium=MB,
        bin_max_large=ML,
        bin_max_big=BB,
        bin_stream_cap=stream_cap,
        max_tris_per_tile=k_cap,
        shadow_tiles_cap=pcf_cap,
        # Reset any inherited lit-pruned cap (e.g. FLAGSHIP's 1104, tuned for
        # the benchmark scene): 0 = inherit the cap derived above, so the
        # sparse-PCF path binds on the freshly calibrated budget on every
        # scene instead of a stale scene-specific override (round-4 advisor).
        shadow_tiles_cap_lit=0,
        max_lights_per_tile=light_cap,
    )
    report = {
        "ladder": (e, em, el),
        "budgets": {"small": LS, "medium": MB, "large": ML, "big": BB},
        "sort_keys": int(keys),
        "stream_cap": stream_cap,
        "max_tris_per_tile": k_cap,
        "shadow_tiles_cap": pcf_cap,
        "max_lights_per_tile": light_cap,
        "measured": {
            "tile_count_max": k_max,
            "pairs_max": pairs_max,
            "covered_tiles_max": covered_max,
            "live_lights_max": lights_max,
        },
        "yaw_steps": yaw_steps,
        "margin": margin,
    }
    return out, report


def autotune_shadow(
    state: SceneState,
    cfg: RendererConfig,
    yaw_steps: int = 24,
    margin: float = 0.3,
):
    """Derive light-view binning tiers for the shadow-map pass
    (cfg.shadow_bin_tiers) the same way autotune derives the display tiers:
    sweep the animation orbit, measure the LIGHT view's footprint occupancy
    per candidate ladder, pick the ladder minimizing the emitted sort-key
    array, budget with margin.  Returns (RendererConfig with
    shadow_bin_tiers set, report dict).

    Uses only triangle AABBs (no rasterization) — the light view is a fixed
    ortho frame; the meshes' yaw animation is what moves footprints.  The
    default (uncalibrated) shadow tiers restore full default-config headroom
    per tier (ops/shadows.py), whose sort-key array is ~2x what the measured
    distribution needs — sorting is the binning cost, so this is worth real
    milliseconds per frame at 1024^2."""
    from .ops.shadows import light_view_proj, setup_light_view_triangles
    from .ops.transform import TRI_VALID

    S = cfg.shadow_map_size
    TH, TW = cfg.tile_h, cfg.tile_w  # shadow_bin_config keeps the tile
    nty, ntx = -(-S // TH), -(-S // TW)
    NT = nty * ntx
    shadow_cfg = dataclasses.replace(cfg, width=S, height=S)
    lvp = light_view_proj(state.lights.direction)

    def light_setup(s):
        # The EXACT geometry path render_shadow_map runs (cull="none",
        # depth-only); only validity + AABBs are consumed.
        tris = setup_light_view_triangles(s, cfg, shadow_cfg, lvp)
        return tris.packed[:, TRI_VALID] > 0, tris.aabb

    setup = jax.jit(light_setup)
    _fps = []
    pairs_max = 0
    s = state
    for _ in range(yaw_steps):
        s = animate(s, 2.0 * np.pi / yaw_steps, cfg)
        valid, aabb = jax.device_get(setup(s))
        tx0 = np.floor(aabb[:, 0] / TW).astype(np.int64)
        ty0 = np.floor(aabb[:, 1] / TH).astype(np.int64)
        tx1 = np.floor(aabb[:, 2] / TW).astype(np.int64)
        ty1 = np.floor(aabb[:, 3] / TH).astype(np.int64)
        live = valid & (tx1 >= 0) & (tx0 < ntx) & (ty1 >= 0) & (ty0 < nty)
        w = np.clip(tx1, 0, ntx - 1) - np.clip(tx0, 0, ntx - 1) + 1
        h = np.clip(ty1, 0, nty - 1) - np.clip(ty0, 0, nty - 1) + 1
        fp = np.where(live, w * h, 0)
        pairs_max = max(pairs_max, int(fp.sum()))
        _fps.append(fp)

    T = _fps[0].shape[0]
    best = None
    for e, em, el in _LADDERS:
        ns = nm = nl = nb = 0
        for fp in _fps:
            lv = fp > 0
            ns = max(ns, int((lv & (fp <= e)).sum()))
            nm = max(nm, int((lv & (fp > e) & (fp <= em)).sum()))
            if el < NT:
                nl = max(nl, int((lv & (fp > em) & (fp <= el)).sum()))
                nb = max(nb, int((lv & (fp > el)).sum()))
            else:
                nl = max(nl, int((lv & (fp > em)).sum()))
        LS = min(_round_up(ns * (1 + margin) + 1, 128), T)
        MB = min(_round_up(nm * (1 + margin) + 1, 8), T)
        ML = min(_round_up(nl * (1 + margin) + 1, 8), T)
        BB = min(max(_round_up(nb * (1 + margin) + 1, 8), 8), T)
        keys = LS * e + MB * em + ML * el + (BB * NT if el < NT else 0)
        cand = (keys, (e, em, el), (LS, MB, ML, BB))
        if best is None or cand[0] < best[0]:
            best = cand

    keys, (e, em, el), (LS, MB, ML, BB) = best
    tiers = (e, em, MB, el, ML, BB, LS)
    out = dataclasses.replace(cfg, shadow_bin_tiers=tiers)
    report = {
        "tiers": tiers,
        "sort_keys": int(keys),
        "pairs_max": pairs_max,
        "tile": (TH, TW),
        "yaw_steps": yaw_steps,
        "margin": margin,
    }
    return out, report


