"""Contact engine tests: QP layer vs exact active-set oracle, geometry
primitives, quasistatic physics sanities, and end-to-end contact solves.

Formalizes the reference's informal cross-checks (python-sim vs C++-sim
gradient comparison, ``run_planar_hand.py:93-107``; bundle-vs-exact gradient
studies, ``box_pivoting_bundle.py``)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from irs_mpc_tpu.models.contact import geometry as geom
from irs_mpc_tpu.models.contact.qp import solve_qp
from irs_mpc_tpu.models.contact.systems import (make_box_pivoting,
                                                make_box_pushing,
                                                make_carrots,
                                                make_planar_hand,
                                                make_plate_pickup)


def _qp_oracle(P, q, C, d):
    """Exact QP solution by active-set enumeration (f64)."""
    n, m = C.shape[1], C.shape[0]
    best, bestval = None, np.inf
    for r in range(m + 1):
        for S in itertools.combinations(range(m), r):
            S = list(S)
            if r:
                KKT = np.block([[P, C[S].T], [C[S], np.zeros((r, r))]])
                rhs = np.concatenate([-q, d[S]])
            else:
                KKT, rhs = P, -q
            try:
                sol = np.linalg.solve(KKT, rhs)
            except np.linalg.LinAlgError:
                continue
            x, lam = sol[:n], sol[n:]
            if np.all(lam >= -1e-9) and np.all(C @ x - d <= 1e-7):
                val = 0.5 * x @ P @ x + q @ x
                if val < bestval:
                    bestval, best = val, x
    return best


@pytest.mark.parametrize("seed", range(6))
def test_qp_matches_active_set_oracle(seed):
    rng = np.random.RandomState(seed)
    n, m = 4, 6
    A = rng.randn(n, n)
    P = A @ A.T + np.eye(n)
    q = rng.randn(n)
    C = rng.randn(m, n)
    d = C @ rng.randn(n) * 0.3 + rng.rand(m) * 0.5
    x = solve_qp(jnp.asarray(P, jnp.float32), jnp.asarray(q, jnp.float32),
                 jnp.asarray(C, jnp.float32), jnp.asarray(d, jnp.float32), 40)
    xo = _qp_oracle(P, q, C, d)
    np.testing.assert_allclose(np.asarray(x), xo, atol=1e-4)


def test_qp_gradient_vs_finite_difference():
    rng = np.random.RandomState(42)
    P = jnp.eye(3)
    qv = jnp.asarray([1., -2., 0.5])
    C = jnp.asarray(rng.randn(4, 3), jnp.float32)
    d = jnp.asarray([0.5, 0.3, -0.1, 1.0], jnp.float32)
    f = lambda qq: solve_qp(P, qq, C, d, 40)
    J = jax.jacfwd(f)(qv)
    eps = 1e-2
    Jfd = np.stack([
        (np.asarray(f(qv.at[i].add(eps))) -
         np.asarray(f(qv.at[i].add(-eps)))) / (2 * eps)
        for i in range(3)], 1)
    np.testing.assert_allclose(np.asarray(J), Jfd, atol=5e-2)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_circle_circle():
    phi, p, n = geom.circle_circle(jnp.array([0., 0.]), 1.0,
                                   jnp.array([3., 0.]), 1.0)
    assert abs(float(phi) - 1.0) < 1e-6
    np.testing.assert_allclose(n, [1., 0.], atol=1e-6)


def test_circle_box_outside_and_inside():
    # Outside, right face.
    phi, p, n = geom.circle_box(jnp.array([2., 0.]), 0.5,
                                jnp.array([0., 0.]), (1., 1.), 0.0)
    assert abs(float(phi) - 0.5) < 1e-6
    np.testing.assert_allclose(n, [1., 0.], atol=1e-6)
    # Inside: nearest face pushout, negative phi.
    phi, p, n = geom.circle_box(jnp.array([0.8, 0.]), 0.1,
                                jnp.array([0., 0.]), (1., 1.), 0.0)
    assert float(phi) < 0
    np.testing.assert_allclose(n, [1., 0.], atol=1e-6)
    # Rotated box: 45 degrees.  The circle center at (2,2) lies along the
    # rotated box's local +x axis, so in box frame it sits at (2*sqrt(2), 0)
    # and the face is at 1: phi = 2*sqrt(2) - 1 - r.
    phi, _, n = geom.circle_box(jnp.array([2., 2.]), 0.1,
                                jnp.array([0., 0.]), (1., 1.),
                                jnp.pi / 4)
    assert abs(float(phi) - (2 * np.sqrt(2) - 1 - 0.1)) < 1e-5


def test_capsule_circle():
    phi, p, n = geom.capsule_circle(jnp.array([-1., 0.]), jnp.array([1., 0.]),
                                    0.1, jnp.array([0.5, 1.0]), 0.2)
    assert abs(float(phi) - 0.7) < 1e-6
    np.testing.assert_allclose(n, [0., 1.], atol=1e-6)


def test_free_body_point_jacobian_rotation():
    body = geom.FreeBody2D(idx_pos=(0, 1), idx_rot=2,
                           shapes=(geom.Circle((0., 0.), 0.5),))
    q = jnp.array([1.0, 2.0, 0.3])
    p = jnp.array([1.5, 2.0])   # on the +y side of the center
    J = body.point_jacobian(q, p)
    # Rotation moves this point in +z (perp of (0.5, 0)).
    np.testing.assert_allclose(J[:, 2], [0.0, 0.5], atol=1e-6)


# ---------------------------------------------------------------------------
# quasistatic physics
# ---------------------------------------------------------------------------

def test_box_pushing_statics_and_push():
    m = make_box_pushing()
    x0 = jnp.asarray([0., 0.5, 0., 0., -0.2], jnp.float32)
    u_hold = x0[3:5]
    x = x0
    for _ in range(3):
        x = m.step(x, u_hold)
    np.testing.assert_allclose(x, x0, atol=1e-3)  # nothing moves, no gravity
    # Push the hand up into the box: box must move up.
    x = x0
    for i in range(10):
        x = m.step(x, jnp.asarray([0., -0.2 + 0.05 * (i + 1)]))
    assert float(x[1]) > 0.55
    # Hand cannot penetrate the box: gap >= 0 (tolerance for QP accuracy).
    gap = float(x[1] - 0.5 - 0.1 - x[4])   # box bottom - hand top
    assert gap > -2e-3


def test_planar_hand_ball_settles_in_grasp():
    ph = make_planar_hand()
    x0 = jnp.asarray([0., 0.35, 0., -np.pi / 4, -np.pi / 4,
                      np.pi / 4, np.pi / 4], jnp.float32)
    u_hold = x0[np.asarray(ph.indices_u_into_x())]
    x = x0
    for _ in range(25):
        x = ph.step(x, u_hold)
    # Ball comes to rest supported by the arms (does not fall through).
    assert 0.3 < float(x[1]) < 0.6
    # And the config is an equilibrium: one more step barely moves it.
    x2 = ph.step(x, u_hold)
    np.testing.assert_allclose(x2, x, atol=2e-3)


def test_quasistatic_jacobian_finite_and_sensible():
    m = make_box_pushing()
    sys = m.system()
    x0 = jnp.asarray([0., 0.5, 0., 0., -0.12], jnp.float32)  # near contact
    u = x0[3:5]
    J = sys.jacobian_xu(x0, u)
    assert J.shape == (5, 7)
    assert bool(jnp.all(jnp.isfinite(J)))
    # Hand dofs track their command stiffly: d(hand)/d(u) ~ I.
    np.testing.assert_allclose(J[3:5, 5:7], np.eye(2), atol=0.1)


def test_gravity_free_fall():
    """Unactuated body in free space falls h^2 * g per step (quasi-dynamic)."""
    from irs_mpc_tpu.models.contact.quasistatic import (ModelInstance,
                                                        QuasistaticModel)
    ball = geom.FreeBody2D(idx_pos=(0, 1), idx_rot=None,
                           shapes=(geom.Circle((0., 0.), 0.1),))
    m = QuasistaticModel(
        name="fall", h=0.1, nq=2,
        models=(ModelInstance("ball", (0, 1), actuated=False,
                              mass=(1.0, 1.0)),),
        bodies=(ball,), pairs=(), gravity=(0.0, -10.0))
    x = jnp.asarray([0., 1.0])
    x1 = m.step(x, jnp.zeros(0))
    np.testing.assert_allclose(x1, [0.0, 1.0 - 0.01 * 10], atol=1e-5)


def test_all_contact_systems_build_and_step():
    for maker, nx, nu in [(make_planar_hand, 7, 4), (make_box_pushing, 5, 2),
                          (make_box_pivoting, 5, 2),
                          (make_plate_pickup, 8, 5)]:
        m = maker()
        assert m.dim_x == nx and m.dim_u == nu
        x = jnp.zeros(nx).at[1].set(1.0)
        u = jnp.zeros(nu)
        out = m.step(x, u)
        assert out.shape == (nx,)
        assert bool(jnp.all(jnp.isfinite(out)))


def test_carrots_builds_and_steps():
    m = make_carrots(n_pieces=20)
    assert m.dim_x == 45 and m.dim_u == 5
    rng = np.random.RandomState(0)
    x = jnp.zeros(45)
    # Gripper above, pieces scattered on the ground.
    x = x.at[0].set(0.0).at[1].set(0.6)
    for k in range(20):
        x = x.at[5 + 2 * k].set(float(rng.uniform(-0.5, 0.5)))
        x = x.at[6 + 2 * k].set(float(0.05 + 0.1 * rng.rand()))
    out = m.step(x, x[np.asarray(m.indices_u_into_x())])
    assert bool(jnp.all(jnp.isfinite(out)))
    # Pieces must not sink below the ground by more than QP tolerance.
    piece_z = np.asarray(out)[6::2]
    assert np.all(piece_z > 0.05 - 2e-2)


def test_planar_hand_irs_mpc_descends():
    """End-to-end contact iRS-MPC (small budget for CI speed)."""
    import sys as _s
    from pathlib import Path
    _s.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from examples.planar_hand import build_solver
    solver, _ = build_solver(num_samples=20, T=20)
    c0 = solver.cost
    solver.iterate(4, verbose=False)
    assert solver.cost_best < 0.3 * c0


# ---------------------------------------------------------------------------
# second-order (MBP-equivalent) dynamics
# ---------------------------------------------------------------------------

def test_mbp2d_settles_and_differentiates():
    from irs_mpc_tpu.models.contact.mbp2d import Mbp2DModel
    base = make_planar_hand(h=0.01)
    mbp = Mbp2DModel(base=base, actuated_mass=(0.5, 0.3, 0.5, 0.3),
                     control_mode="position", damping=0.5)
    sys_ = mbp.system()
    assert sys_.dim_x == 14 and sys_.dim_u == 4
    # Ball starts clear of the arms (starting in penetration would impart a
    # large pushout velocity — correct Anitescu behavior, wrong test intent).
    q0 = np.array([0., 0.45, 0., -np.pi / 4, -np.pi / 4,
                   np.pi / 4, np.pi / 4], np.float32)
    x = jnp.concatenate([jnp.asarray(q0), jnp.zeros(7)])
    u = jnp.asarray(q0[[3, 4, 5, 6]])
    for _ in range(150):
        x = sys_.step(x, u)
    # Ball supported by the arms; velocities decayed.
    assert 0.3 < float(x[1]) < 0.6
    assert float(jnp.max(jnp.abs(x[7:]))) < 1.0
    J = sys_.jacobian_xu(x, u)
    assert bool(jnp.all(jnp.isfinite(J)))


def test_mbp2d_torque_mode_gravity():
    """Torque mode: zero torque on a 1-dof actuated mass under gravity-free
    config -> no motion; constant torque accelerates it."""
    from irs_mpc_tpu.models.contact.mbp2d import Mbp2DModel
    from irs_mpc_tpu.models.contact.quasistatic import (ModelInstance,
                                                        QuasistaticModel)
    body = geom.FreeBody2D(idx_pos=(0, 1), idx_rot=None,
                           shapes=(geom.Circle((0., 0.), 0.1),))
    base = QuasistaticModel(
        name="m", h=0.01, nq=2,
        models=(ModelInstance("m", (0, 1), actuated=True,
                              stiffness=(10., 10.)),),
        bodies=(body,), pairs=(), gravity=(0.0, 0.0))
    mbp = Mbp2DModel(base=base, actuated_mass=(1.0, 1.0), damping=0.0,
                     control_mode="torque")
    sys_ = mbp.system()
    x = jnp.zeros(4)
    x1 = sys_.step(x, jnp.zeros(2))
    np.testing.assert_allclose(x1, np.zeros(4), atol=1e-7)
    # Constant force 1 N on y: after one step v = h * F/m.
    x2 = sys_.step(x, jnp.asarray([1.0, 0.0]))
    np.testing.assert_allclose(float(x2[2]), 0.01, atol=1e-6)


def test_contact_qp_and_gradient_vs_native_active_set_oracle():
    """The on-device PDIP contact QP and its implicit-function JVP vs the
    native C++ active-set oracle (qp_ineq_solve_grad) on REAL contact-step
    QPs — the on-device/native cross-check that replaces the reference's
    python-vs-C++ simulator gradient comparison (run_planar_hand.py:93-107,
    grad_from_active_constraints)."""
    import jax
    from irs_mpc_tpu.models.contact.qp import solve_qp
    from irs_mpc_tpu.models.contact.systems import make_planar_hand
    from irs_mpc_tpu.native import qp_ineq_solve_grad

    m = make_planar_hand(h=0.1)
    q_nom = m.get_x_from_q_dict({
        "sphere": np.array([0.0, 0.35, 0.0]),
        "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
        "arm_right": np.array([np.pi / 4, np.pi / 4])})
    idx_u = m.indices_u_into_x()
    rng = np.random.RandomState(0)
    checked = 0
    for trial in range(6):
        # Realistic perturbation scale: rollout states stay within ~h*v of
        # contact resolution; artificially deep penetrations (phi << 0) need
        # more PDIP iterations than the production qp_iters budget.
        q = jnp.asarray(q_nom + 0.005 * rng.randn(m.nq), jnp.float32)
        u = q[idx_u] + jnp.asarray(0.01 * rng.randn(len(idx_u)), jnp.float32)
        P, b = m._hessian_and_bias(q, u)
        G, phi = m.contact_rows(q)
        C, d = -G, phi

        x = np.asarray(solve_qp(P, b, C, d, m.qp_iters))
        xo, lam, _ = qp_ineq_solve_grad(np.asarray(P, np.float64),
                                        np.asarray(b, np.float64),
                                        np.asarray(C, np.float64),
                                        np.asarray(d, np.float64))
        np.testing.assert_allclose(x, xo, atol=1e-3)

        # Implicit-JVP vs active-set analytic gradient (tangent on the bias,
        # i.e. d(step)/d(command) direction).
        db = 0.1 * rng.randn(m.nq).astype(np.float32)
        _, jx = jax.jvp(lambda bb: solve_qp(P, bb, C, d, m.qp_iters),
                        (b,), (jnp.asarray(db),))
        _, _, dxo = qp_ineq_solve_grad(np.asarray(P, np.float64),
                                       np.asarray(b, np.float64),
                                       np.asarray(C, np.float64),
                                       np.asarray(d, np.float64),
                                       dq=db.astype(np.float64))
        # Soft (PDIP) vs hard (active-set) sensitivities agree away from
        # weakly-active contacts; allow a loose norm-relative tolerance.
        denom = max(1.0, float(np.linalg.norm(dxo)))
        err = float(np.linalg.norm(np.asarray(jx) - dxo)) / denom
        assert err < 0.05, (trial, err)
        checked += 1
    assert checked == 6


def test_lcp_contact_model_one_sided():
    """The LCP (exact complementarity) scheme vs Anitescu's convex
    relaxation — the two contact models the reference's motivating study
    contrasts (examples/box_pushing/analysis/box_on_box.py:57-73):
    LCP reacts only at phi <= 0 (step function), Anitescu ramps force
    through a positive gap that the commanded step would close."""
    import dataclasses

    import jax
    from irs_mpc_tpu.models.contact.systems import make_box_pushing

    ani = make_box_pushing(h=0.1)
    lcp = dataclasses.replace(ani, contact_model="lcp")
    # Hand below the box with a positive gap.
    x = jnp.asarray([0., 0.5, 0., 0., -0.13], jnp.float32)

    # Free space: both schemes identical (no active rows).
    u_free = jnp.asarray([0.05, -0.2], jnp.float32)
    np.testing.assert_allclose(np.asarray(ani.step(x, u_free)),
                               np.asarray(lcp.step(x, u_free)), atol=1e-4)

    # Command that closes the gap and then some: Anitescu's boundary layer
    # moves the box; LCP does not (gap still positive at the start).
    u_push = jnp.asarray([0., -0.13 + 0.1], jnp.float32)
    box_z_ani = float(ani.step(x, u_push)[1])
    box_z_lcp = float(lcp.step(x, u_push)[1])
    assert box_z_ani > 0.51, box_z_ani
    assert abs(box_z_lcp - 0.5) < 1e-4, box_z_lcp

    # LCP's exact gradient is one-sided: zero at a positive gap (this is
    # precisely why the bundled/smoothed gradient is needed).
    J = jax.jacfwd(lcp.step, argnums=1)(x, jnp.asarray([0., -0.13]))
    assert bool(jnp.all(jnp.isfinite(J)))
    assert abs(float(J[1, 1])) < 1e-6

    # Penetrating start: both react; LCP blocks at the velocity level
    # (no -phi pushout), so it ends deeper than Anitescu.
    xpen = x.at[4].set(-0.02)
    u = jnp.asarray([0., 0.05], jnp.float32)
    z_ani = float(ani.step(xpen, u)[1])
    z_lcp = float(lcp.step(xpen, u)[1])
    assert z_ani > z_lcp > 0.5, (z_ani, z_lcp)


def test_warm_start_rollout_matches_converged():
    """Warm-started rollouts (PDIP carried across knots, qp_iters_ws=10)
    must match a fully converged cold rollout (120 iters) — including the
    contact-ONSET knot, where the inherited duals say "inactive" and the
    uniform feasibility shift lets the solver re-activate (per-row slack
    flooring stalls there; see qp._pdip_solve)."""
    import dataclasses

    from irs_mpc_tpu.models.contact.systems import make_planar_hand

    m = make_planar_hand(0.1)
    x0 = m.get_x_from_q_dict(
        {"sphere": np.array([0., 0.35, 0.]),
         "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
         "arm_right": np.array([np.pi / 4, np.pi / 4])})
    rng = np.random.RandomState(0)
    iu = m.indices_u_into_x()
    T = 20
    u_trj = (np.tile(x0[iu], (T, 1))
             + np.cumsum(rng.randn(T, 4) * 0.02, 0).astype(np.float32))
    sys_ws = m.system()
    assert sys_ws.step_ws_fn is not None
    sys_ref = dataclasses.replace(m, qp_iters=120, qp_iters_ws=0).system()
    assert sys_ref.step_ws_fn is None
    xw = jax.jit(sys_ws.rollout)(jnp.asarray(x0), jnp.asarray(u_trj))
    xr = jax.jit(sys_ref.rollout)(jnp.asarray(x0), jnp.asarray(u_trj))
    assert float(jnp.abs(xw - xr).max()) < 1e-4


def test_warm_start_contact_onset():
    """Free flight -> contact: the knot where contact first activates is the
    hard case for a warm-started interior point (previous duals ~ 0)."""
    import dataclasses

    from irs_mpc_tpu.models.contact.systems import make_box_pushing

    m = make_box_pushing(0.1)
    x0 = np.array([0., 0.5, 0., 0., -0.2], np.float32)
    T = 12
    # Hand approaches the box and pushes through the onset.
    u_trj = np.stack([np.array([0., -0.2 + 0.03 * t], np.float32)
                      for t in range(T)])
    sys_ws = m.system()
    sys_ref = dataclasses.replace(m, qp_iters=120, qp_iters_ws=0).system()
    xw = jax.jit(sys_ws.rollout)(jnp.asarray(x0), jnp.asarray(u_trj))
    xr = jax.jit(sys_ref.rollout)(jnp.asarray(x0), jnp.asarray(u_trj))
    assert float(jnp.abs(xw - xr).max()) < 1e-5
    # The box must actually have been pushed (contact was active).
    assert float(xr[-1, 1]) > 0.5 + 5e-3


def test_warm_start_mbp_rollout():
    """Second-order plant: warm-started velocity-QP chain matches the
    converged cold rollout."""
    import dataclasses

    from irs_mpc_tpu.models.contact.mbp2d import Mbp2DModel
    from irs_mpc_tpu.models.contact.systems import make_planar_hand

    base = make_planar_hand(0.1)
    mbp = Mbp2DModel(base=base, actuated_mass=(0.5, 0.3, 0.5, 0.3),
                     control_mode="position", damping=0.5)
    q0 = base.get_x_from_q_dict(
        {"sphere": np.array([0., 0.35, 0.]),
         "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
         "arm_right": np.array([np.pi / 4, np.pi / 4])})
    x0 = np.concatenate([q0, np.zeros(7)]).astype(np.float32)
    u0 = np.array([-np.pi / 2 + 0.5] * 2 + [np.pi / 2 - 0.5] * 2, np.float32)
    u_trj = np.tile(u0, (20, 1))
    sys_ws = mbp.system()
    assert sys_ws.step_ws_fn is not None
    base_ref = dataclasses.replace(base, qp_iters=120, qp_iters_ws=0)
    sys_ref = dataclasses.replace(mbp, base=base_ref).system()
    xw = jax.jit(sys_ws.rollout)(jnp.asarray(x0), jnp.asarray(u_trj))
    xr = jax.jit(sys_ref.rollout)(jnp.asarray(x0), jnp.asarray(u_trj))
    assert float(jnp.abs(xw - xr).max()) < 1e-3


def _contact_nominal(name, model):
    """A contact-engaged configuration of each quasistatic example task."""
    if name == "planar_hand":
        return model.get_x_from_q_dict(
            {"sphere": np.array([0.0, 0.35, 0.0]),
             "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
             "arm_right": np.array([np.pi / 4, np.pi / 4])})
    if name == "plate_pickup":
        return model.get_x_from_q_dict(
            {"plate": np.array([0.0, 0.04, 0.0]),
             "gripper": np.array([0.0, 0.30, 0.0, -0.16, -0.16])})
    if name == "box_pushing":
        return np.array([0., 0.5, 0., 0., -0.12], np.float32)
    return np.array([0.45, 0.5, 0., -0.15, 0.5], np.float32)  # pivoting


def _oracle_step(model, q, u):
    """One quasistatic step through the native f64 active-set oracle."""
    from irs_mpc_tpu.native import qp_ineq_solve_grad
    P, b = model._hessian_and_bias(q, u)
    C, d = model._constraint_rows(q)
    dq, _, _ = qp_ineq_solve_grad(*(np.asarray(a, np.float64)
                                    for a in (P, b, C, d)))
    return np.asarray(q, np.float64) + dq


_CONTACT_TASKS = ["planar_hand", "box_pushing", "box_pivoting",
                  "plate_pickup"]


@pytest.mark.parametrize("name", _CONTACT_TASKS)
def test_xla_pdip_step_matches_native_oracle(name):
    """The vmapped XLA PDIP (the estimation sweep's solver, at the model's
    own qp_iters) vs the native oracle on perturbed contact states of each
    task whose rollout path runs it."""
    import jax
    from irs_mpc_tpu.models.contact import systems

    m = getattr(systems, f"make_{name}")()
    q0 = _contact_nominal(name, m)
    rng = np.random.RandomState(1)
    iu = m.indices_u_into_x()
    B = 6
    xs, us = [], []
    for _ in range(B):
        xs.append(q0 + 0.003 * rng.randn(m.nq))
        us.append(xs[-1][iu] + 0.01 * rng.randn(len(iu)))
    x = jnp.asarray(np.stack(xs), jnp.float32)
    u = jnp.asarray(np.stack(us), jnp.float32)
    got = np.asarray(m.system().step_batch(x, u))
    for i in range(B):
        np.testing.assert_allclose(got[i], _oracle_step(m, x[i], u[i]),
                                   atol=1e-3, err_msg=f"{name} sample {i}")


@pytest.mark.parametrize("name", _CONTACT_TASKS)
def test_warm_chain_matches_native_oracle(name):
    """The warm-started rollout chain (step_ws: each knot's PDIP starts
    from the previous knot's solution, qp_iters_ws iterations) that the
    line search runs, knot by knot against the native oracle's step from
    the same state."""
    import jax
    from irs_mpc_tpu.models.contact import systems

    m = getattr(systems, f"make_{name}")()
    q0 = _contact_nominal(name, m)
    iu = m.indices_u_into_x()
    rng = np.random.RandomState(2)
    T = 6
    u_trj = (np.tile(q0[iu], (T, 1))
             + np.cumsum(rng.randn(T, len(iu)) * 0.005, 0)).astype(np.float32)
    sys_ = m.system()
    assert sys_.step_ws_fn is not None
    xs = np.asarray(jax.jit(sys_.rollout)(jnp.asarray(q0),
                                          jnp.asarray(u_trj)))
    for t in range(T):
        np.testing.assert_allclose(
            xs[t + 1], _oracle_step(m, jnp.asarray(xs[t]),
                                    jnp.asarray(u_trj[t])),
            atol=2e-3, err_msg=f"{name} knot {t}")
