"""Post-processing: tonemap, gamma, bloom, FXAA, and final uint8 quantization.

The reference's only 'post-processing' is the gamma encode at the end of the
lighting shader (pow 1/2.2, lighting.hlsl:48) and the implicit RGBA8 store into the
swapchain (main.cpp:444).  The PBR configs add Reinhard tonemapping, and BASELINE
config 4 adds bloom + FXAA — all fused into the same jitted frame program (zero host
syncs between passes).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import RendererConfig


def reinhard(hdr: jnp.ndarray) -> jnp.ndarray:
    """Reinhard tonemap x/(1+x), per channel."""
    return hdr / (1.0 + hdr)


def gamma_encode(linear: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    return jnp.power(jnp.maximum(linear, 0.0), 1.0 / gamma)


def to_uint8(color: jnp.ndarray) -> jnp.ndarray:
    """Final RGBA8-style quantization to displayable uint8 (swapchain store)."""
    return jnp.round(jnp.clip(color, 0.0, 1.0) * 255.0).astype(jnp.uint8)


def _gaussian_kernel1d(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _blur_separable(img: jnp.ndarray, sigma: float, radius: int) -> jnp.ndarray:
    """Separable gaussian blur on [H, W, C] via weighted shifted-slice
    accumulation (2 x (2r+1) padded slices and multiply-adds, which XLA
    fuses into elementwise passes)."""
    k = _gaussian_kernel1d(sigma, radius)
    H, W, _ = img.shape
    taps = 2 * radius + 1
    x = jnp.pad(img, ((radius, radius), (0, 0), (0, 0)), mode="edge")
    acc = None
    for i in range(taps):
        t = x[i : i + H] * k[i]
        acc = t if acc is None else acc + t
    x = jnp.pad(acc, ((0, 0), (radius, radius), (0, 0)), mode="edge")
    acc = None
    for i in range(taps):
        t = x[:, i : i + W] * k[i]
        acc = t if acc is None else acc + t
    return acc


# Bloom filter shape — shared with parallel/sharded.py's band-exact bloom,
# which must use IDENTICAL constants to stay bit-equal to the single-chip path.
BLOOM_SIGMA = 4.0
BLOOM_RADIUS = 8
BLOOM_DOWNSAMPLE = 4


def bloom(hdr: jnp.ndarray, threshold: float, strength: float,
          sigma: float = BLOOM_SIGMA, radius: int = BLOOM_RADIUS,
          downsample: int = BLOOM_DOWNSAMPLE) -> jnp.ndarray:
    """Threshold -> downsample -> gaussian blur -> upsample -> additive blend."""
    H, W, _ = hdr.shape
    bright = jnp.maximum(hdr - threshold, 0.0)
    ds = bright[::downsample, ::downsample]
    blurred = _blur_separable(ds, sigma, radius)
    up = jnp.repeat(jnp.repeat(blurred, downsample, 0), downsample, 1)[:H, :W]
    return hdr + strength * up


def _luma(c: jnp.ndarray) -> jnp.ndarray:
    return c[..., 0] * 0.299 + c[..., 1] * 0.587 + c[..., 2] * 0.114


def fxaa(color: jnp.ndarray, threshold: float = 0.0312,
         relative_threshold: float = 0.125) -> jnp.ndarray:
    """Compact FXAA: luma edge detect + directional blend.  Operates on the final
    (gamma-encoded) image, as standard FXAA does.  Neighborhood taps are
    edge-clamped (NOT wrapped) so image borders don't alias against the far side."""
    l = _luma(color)

    def shift(a, dy, dx):
        # out[y, x] = a[clamp(y - dy), clamp(x - dx)]
        pad = [(max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))]
        pad += [(0, 0)] * (a.ndim - 2)
        padded = jnp.pad(a, pad, mode="edge")
        h, w = a.shape[0], a.shape[1]
        y0, x0 = max(-dy, 0), max(-dx, 0)
        return padded[y0 : y0 + h, x0 : x0 + w]

    lN, lS = shift(l, 1, 0), shift(l, -1, 0)
    lW, lE = shift(l, 0, 1), shift(l, 0, -1)
    lmin = jnp.minimum(l, jnp.minimum(jnp.minimum(lN, lS), jnp.minimum(lW, lE)))
    lmax = jnp.maximum(l, jnp.maximum(jnp.maximum(lN, lS), jnp.maximum(lW, lE)))
    contrast = lmax - lmin
    edge = contrast >= jnp.maximum(threshold, relative_threshold * lmax)

    # Blend toward the 3x3 neighborhood average along the detected edge.
    cN, cS = shift(color, 1, 0), shift(color, -1, 0)
    cW, cE = shift(color, 0, 1), shift(color, 0, -1)
    avg = (color + cN + cS + cW + cE) / 5.0
    blend = jnp.clip(contrast / jnp.maximum(lmax, 1e-5), 0.0, 0.75)
    out = jnp.where(edge[..., None], color + (avg - color) * blend[..., None], color)
    return out


def apply_post(hdr: jnp.ndarray, cfg: RendererConfig) -> jnp.ndarray:
    """HDR linear -> display [0,1]: bloom -> tonemap -> gamma -> FXAA."""
    x = hdr
    if cfg.bloom:
        x = bloom(x, cfg.bloom_threshold, cfg.bloom_strength)
    if cfg.tonemap == "reinhard":
        x = reinhard(x)
    x = gamma_encode(x, cfg.gamma)
    if cfg.fxaa:
        x = fxaa(x)
    return x
