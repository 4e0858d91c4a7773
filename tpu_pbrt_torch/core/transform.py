"""Host-side affine transforms for scene construction.

Covers the capabilities of pbrt-v3 src/core/transform.{h,cpp} and
quaternion.{h,cpp}: Matrix4x4, Transform (with cached inverse),
Translate/Scale/Rotate/LookAt/Perspective/Orthographic constructors, and
AnimatedTransform (matrix decomposition + quaternion slerp for motion blur).

Design note (TPU-first): transforms only exist on the host during scene
compilation. Everything that reaches the device is already in world space
(triangle vertices) or baked into small matrices (camera raster->world).
float64 is used on the host to keep the compile path precise; arrays are
cast to float32 at scene-compile time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def _as_mat(m) -> np.ndarray:
    a = np.asarray(m, dtype=np.float64)
    if a.shape != (4, 4):
        raise ValueError(f"expected 4x4 matrix, got {a.shape}")
    return a


class Transform:
    """An invertible affine transform: a 4x4 matrix and its inverse."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        if m is None:
            self.m = np.eye(4)
            self.m_inv = np.eye(4)
        else:
            self.m = _as_mat(m)
            self.m_inv = _as_mat(m_inv) if m_inv is not None else np.linalg.inv(self.m)

    # -- composition ------------------------------------------------------
    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def transpose(self) -> "Transform":
        return Transform(self.m.T, self.m_inv.T)

    def is_identity(self) -> bool:
        return np.allclose(self.m, np.eye(4))

    def __eq__(self, other):
        return isinstance(other, Transform) and np.array_equal(self.m, other.m)

    def __repr__(self):
        return f"Transform({self.m.tolist()})"

    def swaps_handedness(self) -> bool:
        return np.linalg.det(self.m[:3, :3]) < 0

    # -- application (host, numpy; vectorized over leading axes) ----------
    def apply_point(self, p) -> np.ndarray:
        p = np.asarray(p, dtype=np.float64)
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3].T + self.m[3, 3]
        w = np.where(w == 0, 1.0, w)
        return r / w[..., None] if np.ndim(w) else (r / w)

    def apply_vector(self, v) -> np.ndarray:
        v = np.asarray(v, dtype=np.float64)
        return v @ self.m[:3, :3].T

    def apply_normal(self, n) -> np.ndarray:
        n = np.asarray(n, dtype=np.float64)
        return n @ self.m_inv[:3, :3]


# -- constructors (pbrt-v3 transform.cpp API surface) ---------------------

def translate(delta) -> Transform:
    d = np.asarray(delta, dtype=np.float64)
    m = np.eye(4)
    m[:3, 3] = d
    mi = np.eye(4)
    mi[:3, 3] = -d
    return Transform(m, mi)


def scale(sx, sy, sz) -> Transform:
    m = np.diag([sx, sy, sz, 1.0])
    mi = np.diag([1.0 / sx, 1.0 / sy, 1.0 / sz, 1.0])
    return Transform(m, mi)


def rotate_x(deg) -> Transform:
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return Transform(m, m.T)


def rotate_y(deg) -> Transform:
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return Transform(m, m.T)


def rotate_z(deg) -> Transform:
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    m = np.eye(4)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return Transform(m, m.T)


def rotate(deg, axis) -> Transform:
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    m = np.eye(4)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return Transform(m, m.T)


def look_at(eye, look, up) -> Transform:
    """camera-to-world transform (pbrt LookAt semantics: +z toward look)."""
    eye = np.asarray(eye, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    dirv = look - eye
    dirv = dirv / np.linalg.norm(dirv)
    right = np.cross(up / np.linalg.norm(up), dirv)
    nr = np.linalg.norm(right)
    if nr < 1e-12:
        # up parallel to dir; pick an arbitrary perpendicular (pbrt errors here)
        tmp = np.array([1.0, 0, 0]) if abs(dirv[0]) < 0.9 else np.array([0, 1.0, 0])
        right = np.cross(tmp, dirv)
        nr = np.linalg.norm(right)
    right /= nr
    new_up = np.cross(dirv, right)
    cam_to_world = np.eye(4)
    cam_to_world[:3, 0] = right
    cam_to_world[:3, 1] = new_up
    cam_to_world[:3, 2] = dirv
    cam_to_world[:3, 3] = eye
    return Transform(cam_to_world)


def perspective(fov_deg, znear, zfar) -> Transform:
    """Projective camera->screen transform (pbrt transform.cpp Perspective)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, zfar / (zfar - znear), -zfar * znear / (zfar - znear)],
            [0, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    inv_tan = 1.0 / math.tan(math.radians(fov_deg) / 2)
    return scale(inv_tan, inv_tan, 1.0) * Transform(persp)


def orthographic(znear, zfar) -> Transform:
    return scale(1.0, 1.0, 1.0 / (zfar - znear)) * translate([0, 0, -znear])


# -- AnimatedTransform ----------------------------------------------------

def _quat_from_matrix(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w,x,y,z), Shepperd's method."""
    t = np.trace(r)
    if t > 0:
        w = math.sqrt(t + 1.0) / 2
        s = 1.0 / (4 * w)
        return np.array([w, (r[2, 1] - r[1, 2]) * s, (r[0, 2] - r[2, 0]) * s, (r[1, 0] - r[0, 1]) * s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(0.0, r[i, i] - r[j, j] - r[k, k] + 1.0))
    q = np.zeros(4)
    q[1 + i] = s / 2
    s = 0.5 / s if s != 0 else 0.0
    q[0] = (r[k, j] - r[j, k]) * s
    q[1 + j] = (r[j, i] + r[i, j]) * s
    q[1 + k] = (r[k, i] + r[i, k]) * s
    return q


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _slerp(t: float, q0: np.ndarray, q1: np.ndarray) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = (1 - t) * q0 + t * q1
    else:
        theta = math.acos(min(1.0, d))
        q = (math.sin((1 - t) * theta) * q0 + math.sin(t * theta) * q1) / math.sin(theta)
    return q / np.linalg.norm(q)


def _decompose(m: np.ndarray):
    """M = T R S per pbrt AnimatedTransform::Decompose (polar decomposition)."""
    t = m[:3, 3].copy()
    upper = m[:3, :3].copy()
    r = upper.copy()
    for _ in range(100):
        r_next = 0.5 * (r + np.linalg.inv(r.T))
        if np.max(np.abs(r_next - r)) < 1e-8:
            r = r_next
            break
        r = r_next
    s = np.linalg.inv(r) @ upper
    return t, _quat_from_matrix(r), s


@dataclass
class AnimatedTransform:
    """Two keyframed transforms with decompose+slerp interpolation.

    Capability match for pbrt-v3 src/core/transform.cpp AnimatedTransform.
    interpolate() is used at scene-compile time to bake per-sample-time
    geometry; motion-blurred primitives get per-time tessellation.
    """

    start: Transform
    end: Transform
    start_time: float = 0.0
    end_time: float = 1.0
    _decomp: tuple = field(init=False, default=None, repr=False)

    @property
    def actually_animated(self) -> bool:
        return not np.allclose(self.start.m, self.end.m)

    def interpolate(self, time: float) -> Transform:
        if not self.actually_animated or time <= self.start_time:
            return self.start
        if time >= self.end_time:
            return self.end
        if self._decomp is None:
            self._decomp = (_decompose(self.start.m), _decompose(self.end.m))
        (t0, q0, s0), (t1, q1, s1) = self._decomp
        dt = (time - self.start_time) / (self.end_time - self.start_time)
        t = (1 - dt) * t0 + dt * t1
        q = _slerp(dt, q0, q1)
        s = (1 - dt) * s0 + dt * s1
        m = np.eye(4)
        m[:3, :3] = _quat_to_matrix(q) @ s
        m[:3, 3] = t
        return Transform(m)


def solve_linear_system_2x2(a, b):
    """pbrt SolveLinearSystem2x2 (used by curve/quadric param solves)."""
    det = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    if abs(det) < 1e-10:
        return None
    x0 = (a[1][1] * b[0] - a[0][1] * b[1]) / det
    x1 = (a[0][0] * b[1] - a[1][0] * b[0]) / det
    return x0, x1
