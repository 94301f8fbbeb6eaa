"""Parity tests: JAX DYN kernel vs the float64 NumPy oracle.

Tolerances: the kernel reproduces the reference's arithmetic order, but XLA's
CPU/GPU codegen may contract mul+add into FMA where NumPy's BLAS does not, so
exact bitwise equality across compilers is not attainable; we assert float64
agreement to ~1e-12 per step and ~1e-9 over a 4-second rollout, which is the
last-ulp-accumulation level.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as P
from gym_pybullet_drones_tpu.ops import aero, quat as quat_ops
from gym_pybullet_drones_tpu.ops.dynamics import DynState, dyn_step

from tests import _oracle as oracle

DT = 1.0 / 240.0


def random_state(rng):
    pos = rng.normal(size=3) * 0.5 + np.array([0, 0, 1.0])
    rpy = rng.normal(size=3) * 0.3
    quat = oracle.rpy_to_quat(rpy)
    vel = rng.normal(size=3) * 0.5
    rpy_rates = rng.normal(size=3) * 2.0
    return pos, quat, vel, rpy_rates


@pytest.mark.parametrize("model", [P.CF2X, P.CF2P, P.RACE])
def test_single_step_bitwise(model):
    rng = np.random.default_rng(0)
    pos, quat, vel, rpy_rates = random_state(rng)
    rpm = model.hover_rpm * (1 + 0.1 * rng.normal(size=4))

    o_pos, o_quat, o_vel, o_rates, o_angv = oracle.dyn_step(
        model, pos, quat, vel, rpy_rates, rpm, DT)

    state = DynState(
        pos=jnp.asarray(pos), quat=jnp.asarray(quat), vel=jnp.asarray(vel),
        rpy_rates=jnp.asarray(rpy_rates), ang_v=jnp.zeros(3, jnp.float64))
    out = jax.jit(lambda s, r: dyn_step(model, s, r, DT))(state, jnp.asarray(rpm))

    np.testing.assert_allclose(np.asarray(out.pos), o_pos, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(out.vel), o_vel, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(out.rpy_rates), o_rates, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(out.quat), o_quat, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(out.ang_v), o_angv, rtol=1e-12, atol=1e-13)


def test_long_rollout_trajectory_parity():
    """960 substeps (4 s @ 240 Hz) under near-hover RPM stay bit-identical."""
    model = P.CF2X
    rng = np.random.default_rng(7)
    pos, quat, vel, rpy_rates = random_state(rng)
    rpms = model.hover_rpm * (1 + 0.02 * rng.normal(size=(960, 4)))

    state = DynState(
        pos=jnp.asarray(pos), quat=jnp.asarray(quat), vel=jnp.asarray(vel),
        rpy_rates=jnp.asarray(rpy_rates), ang_v=jnp.zeros(3, jnp.float64))

    @jax.jit
    def rollout(state, rpms):
        def body(s, r):
            s = dyn_step(model, s, r, DT)
            return s, s.pos
        return jax.lax.scan(body, state, rpms)

    final, traj = rollout(state, jnp.asarray(rpms))

    for t in range(960):
        pos, quat, vel, rpy_rates, _ = oracle.dyn_step(
            model, pos, quat, vel, rpy_rates, rpms[t], DT)
    np.testing.assert_allclose(np.asarray(final.pos), pos, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(final.vel), vel, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(final.quat), quat, rtol=1e-9, atol=1e-9)


def test_zero_omega_integrate_branch():
    """integrate_quat returns q unchanged when ||omega|| ~ 0 (reference :879)."""
    q = jnp.asarray(oracle.rpy_to_quat([0.1, -0.2, 0.3]))
    out = quat_ops.integrate_quat(q, jnp.zeros(3, jnp.float64), DT)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(q))


def test_batched_matches_loop():
    """Batched (env, drone) kernel == per-drone oracle loop."""
    model = P.CF2X
    rng = np.random.default_rng(3)
    B, N = 4, 3
    pos = rng.normal(size=(B, N, 3)) + np.array([0, 0, 1.0])
    rpy = rng.normal(size=(B, N, 3)) * 0.2
    quat = np.stack([[oracle.rpy_to_quat(rpy[b, n]) for n in range(N)]
                     for b in range(B)])
    vel = rng.normal(size=(B, N, 3)) * 0.3
    rates = rng.normal(size=(B, N, 3))
    rpm = model.hover_rpm * (1 + 0.05 * rng.normal(size=(B, N, 4)))

    state = DynState(pos=jnp.asarray(pos), quat=jnp.asarray(quat),
                     vel=jnp.asarray(vel), rpy_rates=jnp.asarray(rates),
                     ang_v=jnp.zeros((B, N, 3), jnp.float64))
    out = jax.jit(lambda s, r: dyn_step(model, s, r, DT))(state, jnp.asarray(rpm))
    for b in range(B):
        for n in range(N):
            o_pos, o_quat, o_vel, o_rates, _ = oracle.dyn_step(
                model, pos[b, n], quat[b, n], vel[b, n], rates[b, n],
                rpm[b, n], DT)
            np.testing.assert_allclose(np.asarray(out.pos[b, n]), o_pos,
                                       rtol=1e-12, atol=1e-13)
            np.testing.assert_allclose(np.asarray(out.quat[b, n]), o_quat,
                                       rtol=1e-12, atol=1e-13)


def test_ground_effect_parity():
    model = P.CF2X
    rng = np.random.default_rng(5)
    pos = np.array([0.1, -0.2, 0.05])
    rpy = np.array([0.05, -0.1, 0.4])
    q = oracle.rpy_to_quat(rpy)
    rpm = model.hover_rpm * np.ones(4) * (1 + 0.01 * rng.normal(size=4))

    o_gnd = oracle.ground_effect(model, rpm, pos, q, rpy)
    rot = quat_ops.quat_to_mat(jnp.asarray(q))
    force, torque = aero.ground_effect(
        model, jnp.asarray(rpm), jnp.asarray(pos), rot, jnp.asarray(rpy))
    # world force z-component: sum(G_i) * R33
    o_rot = oracle.quat_to_mat(q)
    np.testing.assert_allclose(np.asarray(force),
                               np.sum(o_gnd) * o_rot[:, 2], rtol=1e-12)

    # tilted beyond pi/2 -> zero
    rpy2 = np.array([2.0, 0.0, 0.0])
    q2 = oracle.rpy_to_quat(rpy2)
    rot2 = quat_ops.quat_to_mat(jnp.asarray(q2))
    f2, _ = aero.ground_effect(model, jnp.asarray(rpm), jnp.asarray(pos),
                               rot2, jnp.asarray(rpy2))
    np.testing.assert_array_equal(np.asarray(f2), np.zeros(3))


def test_drag_parity():
    model = P.CF2X
    rng = np.random.default_rng(11)
    vel = rng.normal(size=3)
    rpy = rng.normal(size=3) * 0.3
    q = oracle.rpy_to_quat(rpy)
    rpm = model.hover_rpm * np.ones(4)
    o_force = oracle.drag_force(model, rpm, vel, q)
    rot = quat_ops.quat_to_mat(jnp.asarray(q))
    force, _ = aero.drag(model, jnp.asarray(rpm), jnp.asarray(vel), rot)
    np.testing.assert_allclose(np.asarray(force), o_force, rtol=1e-12)


def test_downwash_parity():
    model = P.CF2X
    # drone 0 below drone 1, drone 2 far away
    all_pos = np.array([[0.0, 0.0, 0.5], [0.05, 0.02, 1.0], [20.0, 0.0, 2.0]])
    for n in range(3):
        o_mag = oracle.downwash_force(model, all_pos, n)
        rpys = np.zeros((3, 3))
        quats = np.stack([oracle.rpy_to_quat(r) for r in rpys])
        rot = quat_ops.quat_to_mat(jnp.asarray(quats))
        force, _ = aero.downwash(model, jnp.asarray(all_pos), rot)
        np.testing.assert_allclose(np.asarray(force[n]),
                                   np.array([0, 0, -o_mag]), rtol=1e-12,
                                   atol=1e-18)


def test_urdf_asset_roundtrip():
    """In-package URDF assets parse back to the exact hard-coded params
    (to_urdf <-> from_urdf, reference BaseAviary._parseURDFParameters)."""
    import os
    from gym_pybullet_drones_tpu import params as P
    for prm in (P.CF2X, P.CF2P, P.RACE):
        path = P.asset_path(prm.model)
        assert os.path.exists(path), path
        assert P.from_urdf(path, prm.model) == prm


def test_to_urdf_custom_roundtrip(tmp_path):
    """to_urdf/from_urdf roundtrip for a user-customized model."""
    import dataclasses
    from gym_pybullet_drones_tpu import params as P
    custom = dataclasses.replace(P.CF2X, m=0.031, kf=3.3e-10)
    path = str(tmp_path / "custom.urdf")
    P.to_urdf(custom, path)
    assert P.from_urdf(path) == custom
