"""DirectXMath-parity transform math, row-vector convention, pure JAX.

The reference renderer builds its camera and model matrices with DirectXMath
(reference: source/main.cpp:213-228, 368-375) and consumes them in HLSL with the
row-vector convention ``mul(float4(v, 1), M)`` (reference:
assets/shaders/geometry.hlsl:32-37).  The CPU side transposes every matrix before
upload (main.cpp:226-228) because HLSL defaults to column-major storage; the transpose
and the storage convention cancel, so the *effective* math is plain row-vector
``v @ M`` with DirectXMath's row-major matrices.  This module reproduces exactly that
effective math — points and vectors are rows, matrices compose left-to-right
(``v @ A @ B`` applies A first).

All functions are jit-safe, dtype-polymorphic (float32 by default), and batched over
leading axes where noted.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "look_at_lh",
    "perspective_fov_lh",
    "rotation_roll_pitch_yaw",
    "scaling",
    "translation",
    "model_matrix",
    "transform_points",
    "transform_vectors",
    "normalize",
]

# Every product here is float32 at full precision: a GPU would otherwise run
# default-precision float32 products in TF32 (~3 decimal digits).
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)

XM_PI = 3.141592653589793
XM_2PI = 2.0 * XM_PI
XM_PIDIV4 = XM_PI / 4.0


def normalize(v, axis=-1, eps=0.0):
    """Vector normalize. With eps=0 this matches XMVector3Normalize for nonzero input."""
    n = jnp.linalg.norm(v, axis=axis, keepdims=True)
    return v / jnp.maximum(n, eps) if eps else v / n


def normalize_safe(v, axis=-1):
    """Zero-guarded normalize: zero vectors pass through unchanged (divide by
    1).  The SINGLE definition of the guard the G-buffer encode/decode round
    trip and the shading paths share — they must stay bit-identical."""
    n = jnp.linalg.norm(v, axis=axis, keepdims=True)
    return v / jnp.where(n == 0.0, 1.0, n)


def look_at_lh(eye, at, up, dtype=jnp.float32):
    """Left-handed look-at view matrix (XMMatrixLookAtLH semantics).

    Matches DirectXMath: z axis = normalize(at - eye), x = normalize(up × z),
    y = z × x; translation row = (-eye·x, -eye·y, -eye·z, 1).
    Reference use: main.cpp:214-218 (eye=(0,1,-8), at=origin, up=+Y).
    """
    eye = jnp.asarray(eye, dtype)
    at = jnp.asarray(at, dtype)
    up = jnp.asarray(up, dtype)
    z = normalize(at - eye)
    x = normalize(jnp.cross(up, z))
    y = jnp.cross(z, x)
    # Row-vector convention: basis vectors laid out column-wise.
    r0 = jnp.stack([x[0], y[0], z[0], jnp.zeros((), dtype)])
    r1 = jnp.stack([x[1], y[1], z[1], jnp.zeros((), dtype)])
    r2 = jnp.stack([x[2], y[2], z[2], jnp.zeros((), dtype)])
    r3 = jnp.stack(
        [
            -jnp.dot(x, eye, precision=_HIGHEST),
            -jnp.dot(y, eye, precision=_HIGHEST),
            -jnp.dot(z, eye, precision=_HIGHEST),
            jnp.ones((), dtype),
        ]
    )
    return jnp.stack([r0, r1, r2, r3])


def perspective_fov_lh(fov_y, aspect, z_near, z_far, dtype=jnp.float32):
    """Left-handed perspective projection (XMMatrixPerspectiveFovLH semantics).

    h = cot(fov_y/2), w = h/aspect, clip z in [0, 1]:
        [ w 0 0          0 ]
        [ 0 h 0          0 ]
        [ 0 0 zf/(zf-zn) 1 ]
        [ 0 0 -zn*zf/(zf-zn) 0 ]
    Reference use: main.cpp:219-224 (pi/4, 1280/720, 0.1, 100).
    """
    fov_y = jnp.asarray(fov_y, dtype)
    h = 1.0 / jnp.tan(fov_y * 0.5)
    w = h / aspect
    # fRange = zf / (zf - zn) computed in the TARGET precision, like
    # XMMatrixPerspectiveFovLH's float32 chain — evaluating in Python float64
    # and casting diverges by 1 ulp for many (zn, zf) pairs, off the
    # bit-parity contract (the reference default 0.1/100 coincides either way).
    zn = jnp.asarray(z_near, dtype)
    zf = jnp.asarray(z_far, dtype)
    zr = zf / (zf - zn)
    z0 = jnp.zeros((), dtype)
    z1 = jnp.ones((), dtype)
    return jnp.stack(
        [
            jnp.stack([w, z0, z0, z0]),
            jnp.stack([z0, h, z0, z0]),
            jnp.stack([z0, z0, zr, z1]),
            jnp.stack([z0, z0, -zr * zn, z0]),
        ]
    )


def _rot_x(a, dtype):
    c, s = jnp.cos(a), jnp.sin(a)
    z0, z1 = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([z1, z0, z0, z0], -1),
            jnp.stack([z0, c, s, z0], -1),
            jnp.stack([z0, -s, c, z0], -1),
            jnp.stack([z0, z0, z0, z1], -1),
        ],
        -2,
    ).astype(dtype)


def _rot_y(a, dtype):
    c, s = jnp.cos(a), jnp.sin(a)
    z0, z1 = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, z0, -s, z0], -1),
            jnp.stack([z0, z1, z0, z0], -1),
            jnp.stack([s, z0, c, z0], -1),
            jnp.stack([z0, z0, z0, z1], -1),
        ],
        -2,
    ).astype(dtype)


def _rot_z(a, dtype):
    c, s = jnp.cos(a), jnp.sin(a)
    z0, z1 = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, s, z0, z0], -1),
            jnp.stack([-s, c, z0, z0], -1),
            jnp.stack([z0, z0, z1, z0], -1),
            jnp.stack([z0, z0, z0, z1], -1),
        ],
        -2,
    ).astype(dtype)


def rotation_roll_pitch_yaw(pitch, yaw, roll, dtype=jnp.float32):
    """XMMatrixRotationRollPitchYaw semantics: roll (z) first, then pitch (x), then yaw (y).

    Row-vector convention: M = Rz(roll) @ Rx(pitch) @ Ry(yaw).
    Batched over leading axes of pitch/yaw/roll.
    Reference use: main.cpp:371 with orientation = (pitch, yaw, roll).
    """
    pitch = jnp.asarray(pitch, dtype)
    yaw = jnp.asarray(yaw, dtype)
    roll = jnp.asarray(roll, dtype)
    return _mm(_mm(_rot_z(roll, dtype), _rot_x(pitch, dtype)), _rot_y(yaw, dtype))


def scaling(sx, sy, sz, dtype=jnp.float32):
    """XMMatrixScaling. Batched over leading axes."""
    sx = jnp.asarray(sx, dtype)
    sy = jnp.asarray(sy, dtype)
    sz = jnp.asarray(sz, dtype)
    z0 = jnp.zeros_like(sx)
    z1 = jnp.ones_like(sx)
    return jnp.stack(
        [
            jnp.stack([sx, z0, z0, z0], -1),
            jnp.stack([z0, sy, z0, z0], -1),
            jnp.stack([z0, z0, sz, z0], -1),
            jnp.stack([z0, z0, z0, z1], -1),
        ],
        -2,
    )


def translation(tx, ty, tz, dtype=jnp.float32):
    """XMMatrixTranslation (translation in the last row, row-vector convention)."""
    tx = jnp.asarray(tx, dtype)
    ty = jnp.asarray(ty, dtype)
    tz = jnp.asarray(tz, dtype)
    z0 = jnp.zeros_like(tx)
    z1 = jnp.ones_like(tx)
    return jnp.stack(
        [
            jnp.stack([z1, z0, z0, z0], -1),
            jnp.stack([z0, z1, z0, z0], -1),
            jnp.stack([z0, z0, z1, z0], -1),
            jnp.stack([tx, ty, tz, z1], -1),
        ],
        -2,
    )


def model_matrix(position, orientation, scale, dtype=jnp.float32):
    """Model matrix = S @ R @ T  (scale first, then rotate, then translate).

    Mirrors CalculateModelMatrix (main.cpp:368-375).  ``orientation`` is
    (pitch, yaw, roll) per XMMatrixRotationRollPitchYaw.  Batched over a leading
    axis of all three arguments ([M, 3] each -> [M, 4, 4]).
    """
    position = jnp.asarray(position, dtype)
    orientation = jnp.asarray(orientation, dtype)
    scale = jnp.asarray(scale, dtype)
    s = scaling(scale[..., 0], scale[..., 1], scale[..., 2], dtype)
    r = rotation_roll_pitch_yaw(
        orientation[..., 0], orientation[..., 1], orientation[..., 2], dtype
    )
    t = translation(position[..., 0], position[..., 1], position[..., 2], dtype)
    return _mm(_mm(s, r), t)


def transform_points(points, m):
    """Row-vector point transform: (p, 1) @ M -> homogeneous [.., 4].

    ``points`` [..., 3], ``m`` [..., 4, 4] broadcastable against the batch axes.
    Equivalent to geometry.hlsl:32-34 with the composed matrix.
    """
    p = jnp.concatenate([points, jnp.ones_like(points[..., :1])], axis=-1)
    return jnp.einsum("...i,...ij->...j", p, m, precision=_HIGHEST)


def transform_vectors(vectors, m):
    """Row-vector direction transform: (v, 0) @ M -> [..., 3].

    Matches geometry.hlsl:37 — the reference deliberately transforms normals with
    the *model* matrix, NOT its inverse-transpose (a preserved fidelity quirk:
    normals are only correct under rigid transforms + uniform scale).
    """
    return jnp.einsum(
        "...i,...ij->...j", vectors, m[..., :3, :3], precision=_HIGHEST
    )
