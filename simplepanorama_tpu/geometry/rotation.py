"""Rotation algebra in JAX: Rodrigues exp/log, SVD orthogonalization,
rotation init from homography.

Numerics mirror the reference (bund::get_rot / get_rotvec,
/root/reference/src/math/_bundle_adjust_tools.cpp:74-132, and
stch::approximate_rot, _stitch.cpp:134-154) but are written as branchless
fixed-shape JAX fns (lax.cond-free: jnp.where selects) so they vmap/jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def mm(*ms: jnp.ndarray) -> jnp.ndarray:
    """Matrix product chain at full f32 precision (HIGHEST). Geometry
    goes through this: an f32 matmul may otherwise run in TF32 on a GPU,
    which keeps only ~3 decimal digits."""
    return functools.reduce(
        lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST),
        ms)


def rodrigues(rotvec: jnp.ndarray) -> jnp.ndarray:
    """Rotation vector (3,) -> rotation matrix (3,3).

    Small-angle branch: the reference returns the first-order I + [v]_x for
    theta^2 < 1e-8 (get_rot, _bundle_adjust_tools.cpp:79-85); we blend with
    jnp.where to stay differentiable and branch-free.
    """
    eps = 1e-8
    theta2 = jnp.sum(rotvec * rotvec)
    theta = jnp.sqrt(jnp.maximum(theta2, eps))
    u = rotvec / theta
    K = jnp.array([
        [0.0, -u[2], u[1]],
        [u[2], 0.0, -u[0]],
        [-u[1], u[0], 0.0],
    ])
    R_full = (jnp.eye(3) + jnp.sin(theta) * K
              + (1.0 - jnp.cos(theta)) * mm(K, K))
    Kv = jnp.array([
        [0.0, -rotvec[2], rotvec[1]],
        [rotvec[2], 0.0, -rotvec[0]],
        [-rotvec[1], rotvec[0], 0.0],
    ])
    R_small = jnp.eye(3) + Kv
    return jnp.where(theta2 < eps, R_small, R_full)


def orthogonalize(M: jnp.ndarray) -> jnp.ndarray:
    """Nearest rotation via SVD: R = U diag(1,1,det(UV^T)) V^T."""
    U, _, Vt = jnp.linalg.svd(M)
    d = jnp.linalg.det(mm(U, Vt))
    Vt = Vt.at[2].multiply(jnp.sign(d))
    return mm(U, Vt)


def rotvec_from_matrix(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> rotation vector, with SVD re-orthogonalization first
    (get_rotvec, _bundle_adjust_tools.cpp:104-132)."""
    eps = 1e-8
    Rs = orthogonalize(R)
    v = jnp.array([Rs[2, 1] - Rs[1, 2],
                   Rs[0, 2] - Rs[2, 0],
                   Rs[1, 0] - Rs[0, 1]])
    s = jnp.linalg.norm(v)
    cos_ = jnp.clip((Rs[0, 0] + Rs[1, 1] + Rs[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_)
    mul = jnp.where(s < eps, 0.0, theta / jnp.maximum(s, eps))
    return v * mul


def approximate_rot(K_i: jnp.ndarray, K_j: jnp.ndarray,
                    H: jnp.ndarray) -> jnp.ndarray:
    """Initialize a relative rotation from a homography: the nearest rotation
    to K_j^-1 H K_i (stch::approximate_rot, _stitch.cpp:134-154)."""
    M = jnp.linalg.solve(K_j, mm(H, K_i))
    return orthogonalize(M)
