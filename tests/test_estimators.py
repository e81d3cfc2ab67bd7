"""Estimator tests: each smoothing mode vs ``jax.jacfwd`` ground truth on
smooth systems (the estimator-vs-autodiff validation the reference only does
visually, ``examples/planar_hand/analysis/planar_hand_second_order_test.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from irs_mpc_tpu import SmoothingConfig, estimate_tv_matrices, make_pendulum
from irs_mpc_tpu.models.bicycle import make_bicycle


def _nominal(sys, T=10, seed=0):
    rng = np.random.RandomState(seed)
    u_trj = jnp.asarray(rng.randn(T, sys.dim_u) * 0.2, jnp.float32)
    x_trj = sys.rollout(jnp.asarray(rng.randn(sys.dim_x) * 0.1, jnp.float32),
                        u_trj)
    return x_trj, u_trj


@pytest.mark.parametrize("mode,tol", [
    ("exact", 1e-5),
    ("first_order", 2e-2),
    ("zero_order", 5e-2),
    ("zero_order_B", 5e-2),
    ("zero_order_AB", 5e-2),
])
def test_estimator_approaches_exact_jacobian(mode, tol):
    sys = make_bicycle(0.1)
    x_trj, u_trj = _nominal(sys)
    cfg = SmoothingConfig(num_samples=4000, std_x=0.01, std_u=0.01,
                          decay=lambda it: 1.0, damp=1e-4)
    tv = estimate_tv_matrices(sys, mode, x_trj, u_trj,
                              jax.random.PRNGKey(0), 1.0, cfg)
    AB_exact = sys.jacobian_xu_batch(x_trj[:-1], u_trj)
    A_e, B_e = AB_exact[:, :, :5], AB_exact[:, :, 5:]
    np.testing.assert_allclose(tv.A, A_e, rtol=tol * 10, atol=tol)
    np.testing.assert_allclose(tv.B, B_e, rtol=tol * 10, atol=tol)
    # c must satisfy f(x,u) = A x + B u + c at the nominal.
    f_nom = sys.step_batch(x_trj[:-1], u_trj)
    recon = (jnp.einsum("tij,tj->ti", tv.A, x_trj[:-1])
             + jnp.einsum("tij,tj->ti", tv.B, u_trj) + tv.c)
    np.testing.assert_allclose(recon, f_nom, rtol=1e-4, atol=1e-4)


def test_smoothing_differs_from_exact_on_nonsmooth():
    """At a contact boundary, the smoothed gradient must differ from the
    one-sided exact gradient (the whole point of randomized smoothing)."""
    import dataclasses
    from irs_mpc_tpu import make_three_cart
    # Bypass the sample projection: raw Gaussian samples do penetrate and the
    # bundled gradient picks up the contact coupling.
    sys = dataclasses.replace(make_three_cart(0.1), projection=None)
    # Cart 1 just barely NOT touching cart 2: exact gradient sees no contact.
    x = jnp.array([0.0, 0.21, 1.0, 0.0, 0.0, 0.0])
    x_trj = jnp.stack([x, x])
    u_trj = jnp.zeros((1, 2))
    cfg = SmoothingConfig(num_samples=5000, std_x=0.1, std_u=0.1,
                          decay=lambda it: 1.0)
    tv = estimate_tv_matrices(sys, "zero_order", x_trj, u_trj,
                              jax.random.PRNGKey(1), 1.0, cfg)
    AB_exact = sys.jacobian_xu(x, jnp.zeros(2))
    # The smoothed A couples cart 2's position to cart 1's (contact felt in
    # expectation); the exact one does not.
    assert abs(float(tv.A[0, 1, 0])) > 0.05
    assert abs(float(AB_exact[1, 0])) < 1e-6


def test_projection_decouples_position_sampling():
    """With the projection active, samples live on the non-penetration
    manifold, so the fitted position coupling across the contact vanishes —
    the projected estimator sees contact only through velocities."""
    from irs_mpc_tpu import make_three_cart
    sys = make_three_cart(0.1)
    x = jnp.array([0.0, 0.21, 1.0, 0.0, 0.0, 0.0])
    x_trj = jnp.stack([x, x])
    u_trj = jnp.zeros((1, 2))
    cfg = SmoothingConfig(num_samples=5000, std_x=0.1, std_u=0.1,
                          decay=lambda it: 1.0)
    tv = estimate_tv_matrices(sys, "zero_order", x_trj, u_trj,
                              jax.random.PRNGKey(1), 1.0, cfg)
    assert abs(float(tv.A[0, 1, 0])) < 0.02


def test_variance_decay_schedule():
    cfg = SmoothingConfig(num_samples=10, std_x=1.0, std_u=2.0,
                          decay=lambda it: 1.0 / it ** 0.8)
    sx, su = cfg.stds(2.0, 2, 1)
    np.testing.assert_allclose(su, 2.0 / 2 ** 0.8, rtol=1e-5)
    sx2, su2 = cfg.stds(1.0, 2, 1)
    np.testing.assert_allclose(su2, 2.0, rtol=1e-5)


def test_rng_reproducibility():
    sys = make_pendulum(0.05)
    x_trj, u_trj = _nominal(sys, T=5)
    cfg = SmoothingConfig(num_samples=100, std_x=0.5, std_u=0.5)
    tv1 = estimate_tv_matrices(sys, "zero_order", x_trj, u_trj,
                               jax.random.PRNGKey(7), 1.0, cfg)
    tv2 = estimate_tv_matrices(sys, "zero_order", x_trj, u_trj,
                               jax.random.PRNGKey(7), 1.0, cfg)
    np.testing.assert_array_equal(tv1.A, tv2.A)
    np.testing.assert_array_equal(tv1.B, tv2.B)


def test_zero_order_B_A_source_first_order():
    """zero_order_B with A from averaged first-order Jacobians (the MBP
    reference's semantics, mbp_dynamics.py:387-389): the averaged-A option
    must (a) reuse the same samples as the B fit, (b) smooth A when df/dx is
    nonlinear in u (E[cos(u+du)] = cos(u) e^{-s^2/2} != cos(u)), and (c)
    remain a valid affine model at the nominal via c."""
    from irs_mpc_tpu.models.base import System

    def step(x, u):
        # df/dx = cos(u0) * I: nonlinear in u => averaging visibly smooths A.
        return x * jnp.cos(u[0]) + jnp.array([u[0], 0.5 * u[0]])

    sys = System(name="synth", dim_x=2, dim_u=1, h=0.1, step=step)
    x = jnp.asarray([0.7, -0.3], jnp.float32)
    u = jnp.asarray([0.2], jnp.float32)
    x_trj = jnp.stack([x, sys.step(x, u)])
    u_trj = u[None]
    std_u = 0.5
    cfg_exact = SmoothingConfig(num_samples=4000, std_u=std_u,
                                decay=lambda it: 1.0)
    cfg_first = SmoothingConfig(num_samples=4000, std_u=std_u,
                                decay=lambda it: 1.0,
                                zero_order_B_A_source="first_order")
    key = jax.random.PRNGKey(3)
    tv_e = estimate_tv_matrices(sys, "zero_order_B", x_trj, u_trj, key, 1.0,
                                cfg_exact)
    tv_f = estimate_tv_matrices(sys, "zero_order_B", x_trj, u_trj, key, 1.0,
                                cfg_first)
    # B fits share samples => identical.
    np.testing.assert_allclose(tv_e.B, tv_f.B, atol=1e-6)
    # Exact-at-nominal A is cos(u0) I; averaged A ~= cos(u0) e^{-s^2/2} I.
    np.testing.assert_allclose(np.diag(np.asarray(tv_e.A[0])),
                               np.cos(0.2), atol=1e-5)
    np.testing.assert_allclose(np.diag(np.asarray(tv_f.A[0])),
                               np.cos(0.2) * np.exp(-std_u ** 2 / 2),
                               atol=2e-2)
    # The averaged model still reproduces f at the nominal through c.
    f_nom = sys.step_batch(x_trj[:-1], u_trj)
    recon = (jnp.einsum("tij,tj->ti", tv_f.A, x_trj[:-1])
             + jnp.einsum("tij,tj->ti", tv_f.B, u_trj) + tv_f.c)
    np.testing.assert_allclose(recon, f_nom, atol=1e-5)


def test_fused_sweep_matches_per_knot_contact():
    """The fused est_sweep_fn path (one full-accuracy nominal solve +
    shared-constraint sample sweep, r5) must reproduce the per-knot path's
    fits: identical sample streams by construction, fits within the
    nominal-accuracy difference (the fused f_nom is the FULL solver's
    30-iter solve; the per-knot f0 is the 15-iter surrogate's)."""
    import dataclasses

    from irs_mpc_tpu.models.contact.systems import make_planar_hand
    from irs_mpc_tpu.ops.estimators import estimate_tv_matrices_fnom

    model = make_planar_hand(h=0.1)
    est = model.estimation_surrogate()
    assert est.est_sweep_fn is not None
    est_nohook = dataclasses.replace(est, est_sweep_fn=None)
    T = 6
    q0 = jnp.asarray(model.get_x_from_q_dict(
        {"sphere": np.array([0.0, 0.35, 0.0]),
         "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
         "arm_right": np.array([np.pi / 4, np.pi / 4])}))
    iu = model.indices_u_into_x()
    u_trj = jnp.tile(q0[iu], (T, 1))
    x_trj = model.system().rollout(q0, u_trj)
    cfg = SmoothingConfig(num_samples=16, std_u=0.3, std_x=1e-3,
                          decay_std_x=False)
    key = jax.random.PRNGKey(7)
    it = jnp.asarray(2.0, jnp.float32)
    with jax.default_matmul_precision("highest"):
        for mode in ("zero_order_B", "zero_order_AB"):
            tv_f, f_nom = estimate_tv_matrices_fnom(
                est, mode, x_trj, u_trj, key, it, cfg)
            tv_p, none = estimate_tv_matrices_fnom(
                est_nohook, mode, x_trj, u_trj, key, it, cfg)
            assert f_nom is not None and none is None
            sB = float(jnp.max(jnp.abs(tv_p.B))) + 1e-9
            assert float(jnp.max(jnp.abs(tv_f.B - tv_p.B))) / sB < 1e-4
            assert float(jnp.max(jnp.abs(tv_f.c - tv_p.c))) < 1e-4
        # The hook's f_nom is full-accuracy: must match the TRUE system.
        f_true = model.system().step_batch(x_trj[:-1], u_trj)
        np.testing.assert_allclose(f_nom, f_true, atol=1e-5)
        # need_A=False zeroes A (caller overwrites it) without touching B.
        tv_a, _ = estimate_tv_matrices_fnom(
            est, "zero_order_B", x_trj, u_trj, key, it, cfg, need_A=True)
        tv_na, _ = estimate_tv_matrices_fnom(
            est, "zero_order_B", x_trj, u_trj, key, it, cfg, need_A=False)
        assert bool(jnp.all(tv_na.A == 0.0))
        np.testing.assert_allclose(tv_na.B, tv_a.B, atol=1e-7)


def test_fused_sweep_decouple_reuses_f_nom():
    """decouple_AB(f_nom=...) must equal the recomputing form when handed
    the true-accuracy nominal steps."""
    import dataclasses

    from irs_mpc_tpu.models.contact.systems import make_planar_hand
    from irs_mpc_tpu.ops.estimators import (decouple_AB,
                                            estimate_tv_matrices_fnom)

    model = make_planar_hand(h=0.1)
    est = model.estimation_surrogate()
    sysm = model.system()
    T = 4
    q0 = jnp.asarray(model.get_x_from_q_dict(
        {"sphere": np.array([0.0, 0.35, 0.0]),
         "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
         "arm_right": np.array([np.pi / 4, np.pi / 4])}))
    iu = jnp.asarray(model.indices_u_into_x())
    u_trj = jnp.tile(q0[iu], (T, 1))
    x_trj = sysm.rollout(q0, u_trj)
    cfg = SmoothingConfig(num_samples=8, std_u=0.3, std_x=1e-3,
                          decay_std_x=False)
    with jax.default_matmul_precision("highest"):
        tv, f_nom = estimate_tv_matrices_fnom(
            est, "zero_order_B", x_trj, u_trj, jax.random.PRNGKey(0),
            jnp.asarray(1.0, jnp.float32), cfg, need_A=False)
        d_reuse = decouple_AB(tv, iu, x_trj, u_trj, sysm, f_nom=f_nom)
        d_recomp = decouple_AB(tv, iu, x_trj, u_trj, sysm)
        np.testing.assert_allclose(d_reuse.c, d_recomp.c, atol=1e-5)
        np.testing.assert_allclose(d_reuse.A, d_recomp.A, atol=0)
        np.testing.assert_allclose(d_reuse.B, d_recomp.B, atol=0)


def test_flat_call_restores_namedtuple_outputs():
    """_flat_call rebuilds every output leaf, NamedTuples included (a
    ``type(out)(generator)`` rebuild fails for them)."""
    from typing import NamedTuple

    from irs_mpc_tpu.ops.estimators import _flat_call

    class Pair(NamedTuple):
        a: jnp.ndarray
        b: jnp.ndarray

    x = jnp.arange(3 * 4 * 2, dtype=jnp.float32).reshape(3, 4, 2)
    out = _flat_call(lambda v: Pair(a=v * 2.0, b=v.sum(axis=1)), x)
    assert isinstance(out, Pair)
    assert out.a.shape == (3, 4, 2) and out.b.shape == (3, 4)
    np.testing.assert_allclose(out.a, np.asarray(x) * 2.0)
    np.testing.assert_allclose(out.b, np.asarray(x).sum(axis=2))
    plain = _flat_call(lambda v: (v, v[:, 0]), x)
    assert isinstance(plain, tuple) and plain[1].shape == (3, 4)
