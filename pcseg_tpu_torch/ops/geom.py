"""Closed-form symmetric 3x3 eigensolve, planes and SE(3) poses (port of
pcseg_tpu.ops.geom, the parts the pipeline uses).

``eigh3x3_smallest_c`` (and its [..., 3, 3] form ``eigh3x3_smallest``)
follows Eigen's ``computeDirect`` (shift/scale,
trigonometric roots, cross-product kernel extraction) with the same f32
operation order as the JAX version, so the knife edges of the reference's
plane estimator (plane_estimator.cc:202-207) fall on the same side. It is
deliberately not ``torch.linalg.eigh``.

Planes use the Eigen ``Hyperplane`` convention: ``(n, d)`` with
``d = -n . p``.
"""

from __future__ import annotations

import numpy as np
import torch

# float32 smallest normalized positive value: the reference's eigenvalue
# validity gate (plane_estimator.cc:205).
FLT_MIN = 1.1754944e-38


def _roots_of_depressed_characteristic_c(m00, m01, m02, m11, m12, m22):
    """Ascending eigenvalues of the shifted/scaled symmetric matrix given
    as component grids (Eigen's ``computeRoots``)."""
    c0 = (m00 * m11 * m22
          + 2.0 * m01 * m02 * m12
          - m00 * m12 * m12
          - m11 * m02 * m02
          - m22 * m01 * m01)
    c1 = (m00 * m11 - m01 * m01
          + m00 * m22 - m02 * m02
          + m11 * m22 - m12 * m12)
    c2 = m00 + m11 + m22

    c2_over_3 = c2 * (1.0 / 3.0)
    a_over_3 = torch.clamp_min((c2 * c2_over_3 - c1) * (1.0 / 3.0), 0.0)
    half_b = 0.5 * (c0 + c2_over_3 * (2.0 * c2_over_3 * c2_over_3 - c1))
    q = torch.clamp_min(a_over_3 * a_over_3 * a_over_3 - half_b * half_b, 0.0)

    rho = torch.sqrt(a_over_3)
    theta = torch.atan2(torch.sqrt(q), half_b) * (1.0 / 3.0)
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    sqrt3 = 1.7320508075688772

    e2 = c2_over_3 + 2.0 * rho * cos_t
    e0 = c2_over_3 - rho * (cos_t + sqrt3 * sin_t)
    e1 = c2_over_3 - rho * (cos_t - sqrt3 * sin_t)
    return e0, e1, e2


def eigh3x3_smallest_c(c00, c01, c02, c11, c12, c22, prev_normal=None):
    """Smallest-eigenvalue eigenvector of symmetric 3x3 matrices given as
    six component tensors of one shape ``[...]``.

    Returns ``(evals [..., 3] ascending, vec [..., 3])``. ``prev_normal``
    ([..., 3], optional) flips the vector so its dot with the hint is >= 0
    (the reference's sticky orientation, plane_estimator.cc:209-213).
    """
    dtype = c00.dtype
    eps = 1.1920929e-07 if dtype == torch.float32 else 2.22e-16
    trace = c00 + c11 + c22
    shift = trace * (1.0 / 3.0)
    s00 = c00 - shift
    s11 = c11 - shift
    s22 = c22 - shift
    scale = torch.maximum(
        torch.maximum(torch.maximum(s00.abs(), s11.abs()),
                      torch.maximum(s22.abs(), c01.abs())),
        torch.maximum(c02.abs(), c12.abs()))
    safe_scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    # true division (not reciprocal-multiply), as in the JAX version
    a00, a11, a22 = s00 / safe_scale, s11 / safe_scale, s22 / safe_scale
    a01, a02, a12 = c01 / safe_scale, c02 / safe_scale, c12 / safe_scale

    ev0, ev1, ev2 = _roots_of_depressed_characteristic_c(
        a00, a01, a02, a11, a12, a22)
    evals = torch.stack([ev0 * safe_scale + shift,
                         ev1 * safe_scale + shift,
                         ev2 * safe_scale + shift], dim=-1)

    def extract_kernel(lam):
        """Eigen's extract_kernel: the column with max |diagonal| crossed
        with the other two columns; the larger cross product wins."""
        d0 = a00 - lam
        d1 = a11 - lam
        d2 = a22 - lam
        col0 = (d0, a01, a02)
        col1 = (a01, d1, a12)
        col2 = (a02, a12, d2)

        ad0, ad1, ad2 = d0.abs(), d1.abs(), d2.abs()
        pick0 = (ad0 >= ad1) & (ad0 >= ad2)
        pick1 = (~pick0) & (ad1 >= ad2)

        def sel3(x0, x1, x2):
            return torch.where(pick0, x0, torch.where(pick1, x1, x2))

        ci0 = tuple(sel3(col0[i], col1[i], col2[i]) for i in range(3))
        cn1 = tuple(sel3(col1[i], col2[i], col0[i]) for i in range(3))
        cn2 = tuple(sel3(col2[i], col0[i], col1[i]) for i in range(3))

        def cross(u, v):
            return (u[1] * v[2] - u[2] * v[1],
                    u[2] * v[0] - u[0] * v[2],
                    u[0] * v[1] - u[1] * v[0])

        cr0 = cross(ci0, cn1)
        cr1 = cross(ci0, cn2)
        n0 = cr0[0] * cr0[0] + cr0[1] * cr0[1] + cr0[2] * cr0[2]
        n1 = cr1[0] * cr1[0] + cr1[1] * cr1[1] + cr1[2] * cr1[2]
        use0 = n0 > n1
        norm2 = torch.clamp_min(torch.maximum(n0, n1), FLT_MIN)
        r = torch.rsqrt(norm2)
        best = tuple(torch.where(use0, cr0[i], cr1[i]) * r for i in range(3))
        return best, ci0

    dd0 = ev2 - ev1
    dd1 = ev1 - ev0
    k_is_two = dd0 > dd1
    min_sep = torch.minimum(dd0, dd1)
    max_sep = torch.maximum(dd0, dd1)

    v0_direct, _ = extract_kernel(ev0)
    v2, repr2 = extract_kernel(ev2)

    dot_r = v2[0] * repr2[0] + v2[1] * repr2[1] + v2[2] * repr2[2]
    ortho = tuple(repr2[i] - dot_r * v2[i] for i in range(3))
    ortho_n2 = torch.clamp_min(
        ortho[0] * ortho[0] + ortho[1] * ortho[1] + ortho[2] * ortho[2],
        FLT_MIN)
    r_o = torch.rsqrt(ortho_n2)

    pair_equal = min_sep <= 2.0 * eps * max_sep
    degenerate = (ev2 - ev0) <= eps
    one = torch.ones_like(ev0)
    zero = torch.zeros_like(ev0)
    fallback = (one, zero, zero)
    comp = []
    for i in range(3):
        v0_ortho_i = ortho[i] * r_o
        v0_from_k2_i = torch.where(pair_equal, v0_ortho_i, v0_direct[i])
        vec_i = torch.where(k_is_two, v0_from_k2_i, v0_direct[i])
        comp.append(torch.where(degenerate, fallback[i], vec_i))

    if prev_normal is not None:
        dot = (comp[0] * prev_normal[..., 0]
               + comp[1] * prev_normal[..., 1]
               + comp[2] * prev_normal[..., 2])
        flip = dot < 0.0
        comp = [torch.where(flip, -c, c) for c in comp]
    return evals, torch.stack(comp, dim=-1)


def eigh3x3_smallest(cov, prev_normal=None):
    """:func:`eigh3x3_smallest_c` of [..., 3, 3] symmetric matrices (the
    upper triangle is read): ``(evals [..., 3] ascending, vec [..., 3])``,
    the same f32 semantics."""
    return eigh3x3_smallest_c(
        cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2], prev_normal)


def plane_from_normal_point(normal, point):
    """[..., 4] plane coeffs from a unit normal and a point on the plane."""
    # written out in the sequential order of XLA's 3-term reduce
    offset = -(normal[..., 0] * point[..., 0] + normal[..., 1] * point[..., 1]
               + normal[..., 2] * point[..., 2])
    return torch.cat([normal, offset[..., None]], dim=-1)


def plane_signed_distance(plane, x):
    """Signed distance n.x + d. plane: [..., 4], x: [..., 3] -> [...]."""
    return (plane[..., 0] * x[..., 0] + plane[..., 1] * x[..., 1]
            + plane[..., 2] * x[..., 2]) + plane[..., 3]


def plane_abs_distance(plane, x):
    return plane_signed_distance(plane, x).abs()


def plane_project(plane, x):
    """Orthogonal projection of x onto the plane."""
    return x - plane_signed_distance(plane, x)[..., None] * plane[..., :3]


def pose_from_plane(plane):
    """(R [..., 3, 3], t [..., 3]) of a frame whose +z is the plane normal
    and whose origin is the plane's point closest to the world origin
    (eigenmath::PoseFromPlane, algorithms.h:530): R's columns are the plane
    frame's axes in the world. x is the helper axis least aligned with the
    normal crossed with it, y = z x x."""
    n = plane[..., :3]
    t = -plane[..., 3:4] * n
    ax = n.abs()
    use_x = (ax[..., 0] <= ax[..., 1]) & (ax[..., 0] <= ax[..., 2])
    use_y = ~use_x & (ax[..., 1] <= ax[..., 2])
    eye = torch.eye(3, dtype=plane.dtype, device=plane.device)
    helper = torch.where(use_x[..., None], eye[0],
                         torch.where(use_y[..., None], eye[1], eye[2]))
    x = cross(helper, n)
    x = x * torch.rsqrt(torch.clamp_min(
        x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2],
        FLT_MIN))[..., None]
    y = cross(n, x)
    return torch.stack([x, y, n], dim=-1), t


# ---------------------------------------------------------------------------
# SE(3) poses as (quaternion wxyz, translation)
# ---------------------------------------------------------------------------

def matmul_sums(a, b):
    """[..., I, K] @ [..., K, J] as f32 elementwise sums (no library
    matmul, so no TF32 on the card)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def cross(a, b):
    """Cross product over the last axis, in JAX's expression order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    n2 = q[..., 0:1] * q[..., 0:1] + q[..., 1:2] * q[..., 1:2] \
        + q[..., 2:3] * q[..., 2:3] + q[..., 3:4] * q[..., 3:4]
    return q * torch.rsqrt(torch.clamp_min(n2, FLT_MIN))


def quat_multiply(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4] (wxyz)."""
    qv = q[..., 1:4]
    uv = cross(qv, v)
    uuv = cross(qv, uv)
    return v + 2.0 * (q[..., 0:1] * uv + uuv)


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrices [..., 3, 3] -> unit quaternions wxyz."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(w, x, y, z):
        return torch.stack([w, x, y, z], dim=-1)

    q0 = mk(1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    q1 = mk(m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    q2 = mk(m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21)
    q3 = mk(m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11)
    c0 = tr > 0
    c1 = (m00 >= m11) & (m00 >= m22)
    c2 = m11 >= m22
    q = torch.where(c0[..., None], q0,
                    torch.where(c1[..., None], q1,
                                torch.where(c2[..., None], q2, q3)))
    return quat_normalize(q)


class Pose:
    """SE(3) pose: rotation quaternion ``quat`` (wxyz) and translation
    ``trans``, both tensors."""

    __slots__ = ("quat", "trans")

    def __init__(self, quat=None, trans=None, dtype=torch.float32,
                 device=None):
        self.quat = quat_identity(dtype, device) if quat is None \
            else torch.as_tensor(quat, device=device)
        self.trans = torch.zeros(3, dtype=dtype, device=device) \
            if trans is None else torch.as_tensor(trans, device=device)

    @staticmethod
    def identity(dtype=torch.float32, device=None):
        return Pose(dtype=dtype, device=device)

    @staticmethod
    def from_matrix(rot, trans):
        return Pose(matrix_to_quat(torch.as_tensor(rot)),
                    torch.as_tensor(trans))

    @staticmethod
    def from_arrays(quat, trans, device=None):
        """A pose from array-likes (e.g. ``np.asarray`` of another
        package's pose fields), as f32 tensors on ``device``."""
        return Pose(torch.tensor(np.asarray(quat, np.float32), device=device),
                    torch.tensor(np.asarray(trans, np.float32),
                                 device=device))

    def to(self, device):
        return Pose(self.quat.to(device), self.trans.to(device))

    def rotation_matrix(self):
        return quat_to_matrix(self.quat)

    def apply(self, points):
        return quat_rotate(self.quat, points) + self.trans

    def rotate(self, vectors):
        return quat_rotate(self.quat, vectors)

    def compose(self, other):
        """self * other (apply other first, then self)."""
        return Pose(quat_normalize(quat_multiply(self.quat, other.quat)),
                    quat_rotate(self.quat, other.trans) + self.trans)

    def inverse(self):
        qinv = self.quat * torch.tensor([1.0, -1.0, -1.0, -1.0],
                                        dtype=self.quat.dtype,
                                        device=self.quat.device)
        return Pose(qinv, -quat_rotate(qinv, self.trans))
