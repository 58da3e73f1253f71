"""Quaternion library unit tests (golden values hand-derived)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sphsim.core import quat


def test_mul_identity():
    q = quat.normalize(jnp.array([0.1, 0.2, 0.3, 0.9]))
    np.testing.assert_allclose(quat.mul(q, quat.IDENTITY), q, atol=1e-6)
    np.testing.assert_allclose(quat.mul(quat.IDENTITY, q), q, atol=1e-6)


def test_mul_conjugate_is_identity():
    q = quat.normalize(jnp.array([0.4, -0.2, 0.1, 0.8]))
    np.testing.assert_allclose(
        quat.mul(q, quat.conjugate(q)), quat.IDENTITY, atol=1e-6
    )


def test_rotate_90deg_about_z():
    # 90° about z maps x̂ → ŷ.
    q = quat.from_axis_angle(jnp.array([0.0, 0.0, 1.0]), jnp.pi / 2)
    v = quat.rotate(q, jnp.array([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(v, [0.0, 1.0, 0.0], atol=1e-6)


def test_rotate_matches_mul_sandwich():
    q = quat.normalize(jnp.array([0.3, 0.1, -0.4, 0.85]))
    v = jnp.array([0.5, -1.0, 2.0])
    qv = jnp.concatenate([v, jnp.zeros(1)])
    sandwich = quat.mul(quat.mul(q, qv), quat.conjugate(q))[:3]
    np.testing.assert_allclose(quat.rotate(q, v), sandwich, atol=1e-5)


@pytest.mark.parametrize(
    "yaw,pitch,expected",
    [
        (0.0, 0.0, (0.0, 0.0, 1.0)),
        (90.0, 0.0, (1.0, 0.0, 0.0)),
        (-90.0, 0.0, (-1.0, 0.0, 0.0)),
        (0.0, 90.0, (0.0, -1.0, 0.0)),   # Unity pitch +90 looks down
        (0.0, -90.0, (0.0, 1.0, 0.0)),
        (180.0, 0.0, (0.0, 0.0, -1.0)),
    ],
)
def test_euler_direction_unity_convention(yaw, pitch, expected):
    d = quat.euler_direction(yaw, pitch)
    np.testing.assert_allclose(d, expected, atol=1e-6)


def test_look_rotation_z_to_x():
    # LookRotation(x̂, ŷ) = 90° rotation about y.
    q = quat.look_rotation(jnp.array([1.0, 0.0, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    expected = quat.from_axis_angle(jnp.array([0.0, 1.0, 0.0]), jnp.pi / 2)
    # Same rotation up to sign.
    assert (
        np.allclose(q, expected, atol=1e-6)
        or np.allclose(q, -expected, atol=1e-6)
    )


def test_look_rotation_maps_forward():
    fwd = jnp.array([0.3, -0.5, 0.8])
    up = jnp.array([0.0, 1.0, 0.0])
    q = quat.look_rotation(fwd, up)
    z = quat.rotate(q, jnp.array([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(z, fwd / jnp.linalg.norm(fwd), atol=1e-5)
    # Unit quaternion.
    np.testing.assert_allclose(jnp.linalg.norm(q), 1.0, atol=1e-6)


def test_integrate_angular():
    # ω = π about z for dt=1 → 180° turn: x̂ → −x̂.
    q = quat.integrate_angular(quat.IDENTITY, jnp.array([0.0, 0.0, jnp.pi]), 1.0)
    v = quat.rotate(q, jnp.array([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(v, [-1.0, 0.0, 0.0], atol=1e-5)


def test_integrate_angular_small_angle_noop():
    # Below the 1e-5 gate (compute:397) the quaternion is untouched.
    q0 = quat.normalize(jnp.array([0.1, 0.2, 0.3, 0.9]))
    q = quat.integrate_angular(q0, jnp.array([1e-7, 0.0, 0.0]), 1.0)
    np.testing.assert_array_equal(q, q0)


def test_from_matrix_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(-np.pi, np.pi)
        q0 = quat.from_axis_angle(jnp.asarray(axis, jnp.float32), angle)
        # Build matrix columns from rotated basis vectors, then convert back.
        cols = [quat.rotate(q0, jnp.eye(3, dtype=jnp.float32)[i]) for i in range(3)]
        m = jnp.stack(cols, axis=-1)
        q1 = quat.from_matrix(m)
        assert (
            np.allclose(q0, q1, atol=1e-5) or np.allclose(q0, -q1, atol=1e-5)
        )
