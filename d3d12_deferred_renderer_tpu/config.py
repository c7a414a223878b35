"""RendererConfig — the complete flag surface of the renderer.

The reference has no config system (SURVEY.md §5): every knob is a compile-time
constant in source/main.cpp or hardcoded in the HLSL.  This dataclass exposes each of
those constants with the reference value as its default, plus the knobs this
renderer adds on top (PBR, light culling, post chain, tiling, batching).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .xmath import XM_PIDIV4


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    # --- Window / framebuffer (main.cpp:78-79) ---
    width: int = 1280
    height: int = 720

    # --- Presentation (main.cpp:84, 167-171) ---
    frames_in_flight: int = 3  # triple buffering

    # --- Camera (main.cpp:214-224) ---
    eye: Tuple[float, float, float] = (0.0, 1.0, -8.0)
    at: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y: float = XM_PIDIV4
    z_near: float = 0.1
    z_far: float = 100.0

    # --- Animation (main.cpp:201-207): yaw advances 0.01 rad per frame, mod 2pi ---
    yaw_per_frame: float = 0.01

    # --- Directional light (main.cpp:245-247) ---
    light_direction: Tuple[float, float, float] = (-0.3, -0.2, -1.0)
    light_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    # --- Material constants (geometry.hlsl:46-49) ---
    albedo: Tuple[float, float, float] = (0.8, 0.2, 0.2)
    metalness: float = 0.0
    roughness: float = 0.5

    # --- Lighting constants (lighting.hlsl:45, 37, 48) ---
    ambient: float = 0.3
    gamma: float = 2.2

    # --- G-buffer quantization parity (main.cpp:476, 485, 509) ---
    # GB0 is RGBA8_UNORM, GB1 is R10G10B10A2_UNORM, depth D32_FLOAT.  When True the
    # G-buffer is quantized exactly like the reference formats between the passes.
    quantize_gbuffer: bool = True

    # --- Background: the reference clears the backbuffer to cornflower blue
    # (main.cpp:294-297) but the fullscreen lighting triangle then overwrites every
    # pixel (DrawInstanced(3,...), no depth test, no blending, main.cpp:307), shading
    # the cleared-to-zero G-buffer to black.  Parity therefore means "shade every
    # pixel"; the clear color is preserved here only for documentation. ---
    clear_color: Tuple[float, float, float] = (0.39, 0.58, 0.93)

    # --- Shading model: "lambert" is reference parity (lighting.hlsl:32-51);
    # "pbr" is Cook-Torrance GGX over the same G-buffer (BASELINE configs 2-3). ---
    shading: str = "lambert"

    # --- Tonemap applied in pbr mode before gamma ("none" | "reinhard") ---
    tonemap: str = "reinhard"

    # --- Post chain (BASELINE config 4) ---
    bloom: bool = False
    bloom_threshold: float = 1.0
    bloom_strength: float = 0.15
    fxaa: bool = False

    # --- Shadow mapping (BASELINE config 4): directional-light ortho shadow map ---
    shadows: bool = False
    shadow_map_size: int = 1024
    # Shadow-visibility sampling rate divisor: 1 = compare at every pixel
    # (exact); d > 1 compares at every d-th pixel and bilinearly upsamples the
    # visibility (softer penumbra edges).
    shadow_vis_downsample: int = 1

    # Sparse PCF tile cap: shadow visibility samples only screen tiles that
    # contain geometry (background tiles shade to black regardless), compacted
    # to at most this many (8, 128) tiles.  -1 = auto (3/4 of the tile grid),
    # 0 = disable (always dense).  Covered tiles beyond the cap are dropped
    # with a LOUD overflow count (no silent drop), like the binning caps.
    # Default is DENSE: the win is scene-dependent (geometry coverage), and a
    # scene covering more tiles than the cap would lose shadows (loudly).
    # FLAGSHIP_CONFIG opts in (the benchmark scene covers ~53% of tiles).
    shadow_tiles_cap: int = 0

    # Sparse-PCF tile cap when a lit-facing mask prunes the compaction
    # (shadow_visibility's lit_mask): tiles
    # with no NdotL>0 geometry pixel never consume vis, so the LIT-pruned
    # covered count is all the cap must hold, and the PCF gather count scales
    # with the STATIC cap.  0 = inherit shadow_tiles_cap (the safe default,
    # sized for the unpruned covered count); negative = auto, 3/4 of the tile
    # grid, exactly like a negative shadow_tiles_cap.  Only consulted when a
    # lit mask is actually supplied; covered-lit tiles beyond it drop shadows
    # LOUDLY via the same overflow counter.
    shadow_tiles_cap_lit: int = 0

    # Window-gather PCF (sparse path only): gather ONE 4x4-texel window row
    # per 2x2 pixel quad instead of one 2x2-footprint row per pixel — ~4x
    # fewer shadow-map gathers.  BIT-exact: quads whose four bilinear
    # footprints don't fit a 4x4 window (depth edges, grazing angles) fall
    # back to per-pixel taps from the same packed table (lanes of the pixel's
    # own window), compacted to shadow_bad_quads_cap entries; more bad quads
    # than the cap raises the LOUD overflow counter (never a silent drop).
    # -1 = auto (1/8 of the sparse pixel budget).
    # OFF by default: no configuration turns it on.
    shadow_window_gather: bool = False
    shadow_bad_quads_cap: int = -1

    # Light-view binning tiers for the shadow-map pass, as
    # (bin_expand, bin_expand_medium, bin_max_medium, bin_expand_large,
    #  bin_max_large, bin_max_big, bin_max_small).  None = the safe
    # default (ops/shadows.py restores at least default-config headroom per
    # tier — wide, never narrowed by camera-tuned display budgets, but its
    # sort-key array is ~2x what the light view's measured footprint
    # distribution needs).  calibrate.autotune_shadow derives a tuned tuple
    # from the scene's light-view occupancy over the animation orbit; every
    # tier still overflows LOUDLY at runtime.
    shadow_bin_tiers: Tuple[int, int, int, int, int, int, int] | None = None

    # --- Procedural normal mapping (BASELINE config 4; the reference has no
    # textures, so the height field is analytic — see ops/bump.py) ---
    normal_mapping: bool = False
    bump_strength: float = 0.35
    bump_frequency: float = 24.0

    # --- Supersampled antialiasing: render at N x resolution, box-filter down.
    # The reference has MSAA off (SampleDesc {1,0}, main.cpp:767); SSAA is the
    # renderer-agnostic quality knob on top. ---
    supersample: int = 1

    # --- Camera flythrough (BASELINE config 5): orbit the camera with the
    # animation clock instead of the fixed reference camera ---
    animate_camera: bool = False
    orbit_radius: float = 8.0
    orbit_height: float = 2.5
    # Whole revolutions per animation-clock cycle (rounded at use, min 1):
    # the clock wraps at 2*pi (reference quirk), so a fractional rate would
    # teleport the orbiting camera at every wrap (scene.animate).
    orbit_speed: float = 1.0

    # --- Rasterizer tiling knobs ---
    # Screen tile: the binning grid and one raster-kernel program.  Powers of
    # two (a Triton block); 8 x 128 measured within ~6% of 16 x 64 and
    # 32 x 32 on the flagship frame (PERF.md), and the binning budgets below
    # are sized on it.
    tile_h: int = 8
    tile_w: int = 128
    max_tris_per_tile: int = 256  # binning cap per tile (K)
    # Sort-based binning (large scenes): four expansion tiers sized so the
    # sort-key array stays small (its sort is the binning cost).  Triangles
    # covering <= bin_expand tiles emit that many (tile, tri) keys from a
    # dense [T, bin_expand] expansion; up to bin_max_medium triangles covering
    # <= bin_expand_medium tiles emit from a compacted [max_medium, medium]
    # expansion; likewise up to bin_max_large triangles covering
    # <= bin_expand_large tiles; up to bin_max_big still-larger triangles
    # expand against the full tile grid (the grid-wide [B, NT] tier is by far
    # the widest per-triangle emission — at 1080p it was over half of all sort
    # keys before the large tier split it off, for a handful of triangles).
    # Exceeding a tier budget is reported via the loud binning overflow
    # counter.
    bin_expand: int = 4
    bin_expand_medium: int = 32
    bin_max_medium: int = 512
    bin_expand_large: int = 256
    bin_max_large: int = 64
    bin_max_big: int = 16
    # Small-tier compaction budget: at most this many triangles route through
    # the [budget, bin_expand] small-rect expansion (ALL tiers are compacted by
    # one record sort; the budget bounds the emitted key count).  -1 = every
    # record (never overflows, but dead records — backface-culled triangles and
    # unused near-clip slots, ~75% on the benchmark scene — pad the sort).
    # Exceeding a positive budget drops triangles LOUDLY via the overflow
    # counter, like every other binning cap.
    bin_max_small: int = -1
    # Compacted record-stream capacity (rows = binned (tile, tri) pairs): the
    # raster kernel reads each tile's segment of this stream; exceeding the
    # cap clamps tail tiles and reports overflow.
    bin_stream_cap: int = 65536
    max_lights_per_tile: int = 64  # light-culling cap per tile
    # Runtime overflow signal (debug-layer philosophy, main.cpp:379-390): when a
    # tile's triangle or light list exceeds its cap the excess is dropped; with
    # this flag the frame program emits a device-side warning print whenever
    # that happens instead of failing silently.  render_stats() exposes the
    # overflow count for callers that want to assert/raise.
    overflow_warn: bool = True
    # Hand-written Pallas-Triton kernels on a GPU (ops/dispatch.py); False
    # runs the plain-XLA oracles everywhere.
    use_pallas: bool = True

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)


# Reference-parity default (config 1 of BASELINE.json).
REFERENCE_CONFIG = RendererConfig()

# BASELINE.json config 3: 1080p, 256 point lights, PBR with per-tile light culling.
# K=512 keeps every tile of the benchmark scene under the binning cap (overflow 0),
# and the light cap equals the light count so culling can NEVER drop a
# contributing light (the benchmark's light density exceeds 64/tile even with
# depth-aware culling — a smaller cap silently under-shades).
#
# Every scene-dependent budget below is reproducible from calibrate.autotune,
# which derives the same tier ladder over the yaw orbit (measured orbit maxima
# on this scene: tile max 414, pairs 26,535, covered 1,068 tiles); every cap
# exceeds them and overflows LOUDLY when a scene does not fit.
FLAGSHIP_CONFIG = dataclasses.replace(
    REFERENCE_CONFIG,
    width=1920,
    height=1080,
    shading="pbr",
    max_tris_per_tile=512,
    max_lights_per_tile=256,
    # Binning tiers sized on the benchmark scene's footprint distribution
    # over the full yaw orbit (24 samples): live records max 11,215 of
    # 47,812 (backface cull + unused clip slots), fp<=2 max 9,224, fp in 3..8
    # max 1,957, fp in 9..64 max 36, fp>64 max 5.  Budgets carry ~30%+
    # margin, and the stream cap covers the max 26,429 binned pairs with
    # ~24% margin.  Every budget overflows LOUDLY.
    bin_expand=2,
    bin_expand_medium=8,
    bin_max_medium=3072,
    bin_expand_large=64,
    bin_max_large=128,
    bin_max_big=8,
    bin_max_small=12288,
    bin_stream_cap=32768,
    # Sparse PCF (sample only geometry-covered tiles): the PCF gather count
    # scales with the STATIC cap, not the covered count.  Covered tiles over
    # the full yaw orbit (40 samples): max 1070 / 2025; 1160 carries ~8%
    # margin and stays a multiple of 8.  A scene or viewpoint exceeding it
    # drops shadows LOUDLY via the overflow counter.
    shadow_tiles_cap=1160,
)
