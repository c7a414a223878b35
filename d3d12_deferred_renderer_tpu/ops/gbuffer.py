"""G-buffer encode/decode with the reference's render-target format quantization.

The reference's geometry pass writes two MRTs (main.cpp:476-488, 720-722):
  GB0 = DXGI_FORMAT_R8G8B8A8_UNORM    : albedo.rgb + metalness.a  (geometry.hlsl:51)
  GB1 = DXGI_FORMAT_R10G10B10A2_UNORM : worldNormal*0.5+0.5 + roughness.a
                                        (geometry.hlsl:52)
  depth = DXGI_FORMAT_D32_FLOAT       : NDC z, cleared to 1.0 (main.cpp:509, 194)

Pixel parity "within tonemap quantization" (BASELINE.md) requires quantizing the
G-buffer exactly like those UNORM formats — 8 bits for GB0, 10/10/10/2 for GB1 —
between the passes, not carrying f32 through.  D3D float->UNORM conversion rounds to
nearest (ties to even), which jnp.round matches.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import RendererConfig
from ..scene import Materials
from .raster_ref import FragmentPlanes


class GBuffer(NamedTuple):
    gb0: jnp.ndarray    # [H, W, 4] albedo.rgb + metalness (unorm8-quantized values)
    gb1: jnp.ndarray    # [H, W, 4] encoded normal + roughness (unorm10/2-quantized)
    depth: jnp.ndarray  # [H, W] f32 NDC depth


def quantize_unorm(x: jnp.ndarray, bits: int) -> jnp.ndarray:
    """Float -> UNORM(bits) -> float round trip (D3D render-target store + sample)."""
    scale = float((1 << bits) - 1)
    return jnp.round(jnp.clip(x, 0.0, 1.0) * scale) / scale


def encode_gbuffer(
    frags: FragmentPlanes, materials: Materials, cfg: RendererConfig
) -> GBuffer:
    """The 'pixel shader' tail of the geometry pass (geometry.hlsl:42-55).

    The interpolated world normal is renormalized per pixel (geometry.hlsl:48) and
    encoded n*0.5+0.5; material constants are gathered per mesh id.  Background
    pixels keep the cleared value 0 (main.cpp:189-193).
    """
    covered = frags.mesh_id >= 0
    mid = jnp.maximum(frags.mesh_id, 0)

    from ..xmath import normalize_safe

    n = normalize_safe(frags.normal)

    albedo = materials.albedo[mid]        # [H, W, 3]
    metal = materials.metalness[mid]      # [H, W]
    rough = materials.roughness[mid]      # [H, W]

    gb0 = jnp.concatenate([albedo, metal[..., None]], axis=-1)
    gb1 = jnp.concatenate([n * 0.5 + 0.5, rough[..., None]], axis=-1)

    gb0 = jnp.where(covered[..., None], gb0, 0.0)
    gb1 = jnp.where(covered[..., None], gb1, 0.0)

    if cfg.quantize_gbuffer:
        gb0 = quantize_unorm(gb0, 8)
        gb1 = jnp.concatenate(
            [
                quantize_unorm(gb1[..., :3], 10),
                quantize_unorm(gb1[..., 3:], 2),
            ],
            axis=-1,
        )
    return GBuffer(gb0=gb0, gb1=gb1, depth=frags.depth)


class DecodedGBuffer(NamedTuple):
    albedo: jnp.ndarray     # [H, W, 3] linear (sRGB-decoded)
    metalness: jnp.ndarray  # [H, W]
    normal: jnp.ndarray     # [H, W, 3] unit
    roughness: jnp.ndarray  # [H, W]


def decode_gbuffer(gb: GBuffer, cfg: RendererConfig) -> DecodedGBuffer:
    """The decode prologue of the lighting pass (lighting.hlsl:34-40):
    albedo sRGB->linear via pow 2.2, normal via *2-1 then normalize."""
    albedo = jnp.power(jnp.maximum(gb.gb0[..., :3], 0.0), cfg.gamma)
    metal = gb.gb0[..., 3]
    from ..xmath import normalize_safe

    n = normalize_safe(gb.gb1[..., :3] * 2.0 - 1.0)
    rough = gb.gb1[..., 3]
    return DecodedGBuffer(albedo=albedo, metalness=metal, normal=n, roughness=rough)
