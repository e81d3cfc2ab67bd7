"""Boxed TV-LQR (ADMM) vs the native C++ QP oracle — the
"(c) ≡ OSQP on random instances" test from SURVEY §7 step 2."""
import jax.numpy as jnp
import numpy as np
import pytest

from irs_mpc_tpu.native import qp_box_eq_solve
from irs_mpc_tpu.ops import admm as admm_ops
from irs_mpc_tpu.ops import lqr as lqr_ops


def _random_problem(T=6, n=3, m=2, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(T, n, n) * 0.3 + np.eye(n)
    B = rng.randn(T, n, m) * 0.5
    c = rng.randn(T, n) * 0.1
    Q = np.diag(rng.rand(n) + 0.5)
    R = np.diag(rng.rand(m) + 0.5)
    Qd = Q * 3.0
    x0 = rng.randn(n) * 0.5
    xd = rng.randn(T + 1, n) * 0.5
    j = lambda a: jnp.asarray(a, jnp.float32)
    return j(A), j(B), j(c), j(Q), j(Qd), j(R), j(x0), j(xd)


def _oracle_solve(prob: lqr_ops.LqrProblem, x_lb, x_ub, u_lb, u_ub):
    """Dense oracle: stack w = [x_0..x_T, u_0..u_{T-1}], box on everything."""
    A = np.asarray(prob.A, np.float64)
    B = np.asarray(prob.B, np.float64)
    c = np.asarray(prob.c, np.float64)
    T, n, m = B.shape
    nx = (T + 1) * n
    nv = nx + T * m

    H = np.zeros((nv, nv))
    f = np.zeros(nv)
    xi = lambda t: slice(t * n, (t + 1) * n)
    ui = lambda t: slice(nx + t * m, nx + (t + 1) * m)
    for t in range(T):
        H[xi(t), xi(t)] += 2 * np.asarray(prob.Q[t], np.float64)
        H[ui(t), ui(t)] += 2 * np.asarray(prob.R[t], np.float64)
        N = np.asarray(prob.N[t], np.float64)
        H[xi(t), ui(t)] += 2 * N
        H[ui(t), xi(t)] += 2 * N.T
        f[xi(t)] += 2 * np.asarray(prob.q[t], np.float64)
        f[ui(t)] += 2 * np.asarray(prob.r[t], np.float64)
    H[xi(T), xi(T)] += 2 * np.asarray(prob.Qf, np.float64)
    f[xi(T)] += 2 * np.asarray(prob.qf, np.float64)

    ne = (T + 1) * n
    E = np.zeros((ne, nv))
    d = np.zeros(ne)
    E[0:n, xi(0)] = np.eye(n)
    d[0:n] = np.asarray(prob.x0, np.float64)
    for t in range(T):
        r0 = (t + 1) * n
        E[r0:r0 + n, xi(t)] = A[t]
        E[r0:r0 + n, ui(t)] = B[t]
        E[r0:r0 + n, xi(t + 1)] = -np.eye(n)
        d[r0:r0 + n] = -c[t]

    lb = np.concatenate([np.tile(x_lb, T + 1), np.tile(u_lb, T)])
    ub = np.concatenate([np.tile(x_ub, T + 1), np.tile(u_ub, T)])
    # x_0 is pinned by equality; relax its box to avoid conflict.
    lb[0:n] = -1e9
    ub[0:n] = 1e9
    w = qp_box_eq_solve(H, f, E, d, lb, ub, rho=10.0, iters=20000, tol=1e-12)
    return w[:nx].reshape(T + 1, n), w[nx:].reshape(T, m)


def test_unconstrained_boxes_match_riccati():
    """With wide boxes the ADMM solve must equal the pure Riccati solution."""
    A, B, c, Q, Qd, R, x0, xd = _random_problem(seed=1)
    prob = lqr_ops.build_tracking_problem(A, B, c, Q, Qd, R, x0, xd)
    T, n, m = B.shape
    big = 1e4
    bounds = admm_ops.BoxBounds(
        x=jnp.stack([jnp.full((T + 1, n), -big), jnp.full((T + 1, n), big)]),
        u=jnp.stack([jnp.full((T, m), -big), jnp.full((T, m), big)]))
    sol = admm_ops.solve_boxed_tvlqr(prob, bounds, n_phys=n, iters=40)
    x_ref, u_ref, _ = lqr_ops.lqr_solve(prob)
    np.testing.assert_allclose(sol.x_trj, x_ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(sol.u_trj, u_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boxed_matches_native_oracle(seed):
    A, B, c, Q, Qd, R, x0, xd = _random_problem(T=6, n=3, m=2, seed=seed)
    prob = lqr_ops.build_tracking_problem(A, B, c, Q, Qd, R, x0, xd)
    T, n, m = B.shape
    # Tight-ish input box + loose state box so constraints actually bind.
    u_lb, u_ub = -0.3 * np.ones(m), 0.3 * np.ones(m)
    x_lb, x_ub = -2.0 * np.ones(n), 2.0 * np.ones(n)
    bounds = admm_ops.BoxBounds(
        x=jnp.stack([jnp.tile(jnp.asarray(x_lb, jnp.float32), (T + 1, 1)),
                     jnp.tile(jnp.asarray(x_ub, jnp.float32), (T + 1, 1))]),
        u=jnp.stack([jnp.tile(jnp.asarray(u_lb, jnp.float32), (T, 1)),
                     jnp.tile(jnp.asarray(u_ub, jnp.float32), (T, 1))]))
    sol = admm_ops.solve_boxed_tvlqr(prob, bounds, n_phys=n, rho=5.0,
                                     iters=300)
    x_or, u_or = _oracle_solve(prob, x_lb, x_ub, u_lb, u_ub)
    assert float(sol.r_primal) < 1e-3
    np.testing.assert_allclose(sol.u_trj, u_or, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(sol.x_trj, x_or, rtol=2e-2, atol=2e-2)
    # The binding input bounds must be respected.
    assert np.all(np.asarray(sol.u_trj) <= u_ub + 1e-3)
    assert np.all(np.asarray(sol.u_trj) >= u_lb - 1e-3)


def test_native_oracle_simple_qp():
    """Sanity: min (w-2)^2 with w <= 1 -> w = 1; equality w0 + w1 = 1."""
    P = np.eye(2) * 2
    f = np.array([-4.0, 0.0])
    E = np.array([[1.0, 1.0]])
    d = np.array([1.0])
    lb = np.array([-10.0, -10.0])
    ub = np.array([10.0, 10.0])
    w = qp_box_eq_solve(P, f, E, d, lb, ub)
    # KKT: w = argmin (w0-2)^2 + w1^2/... actually: 0.5 w'Pw + f'w
    # = w0^2 - 4 w0 + w1^2, s.t. w0 + w1 = 1 -> w0 = 1.5, w1 = -0.5.
    np.testing.assert_allclose(w, [1.5, -0.5], atol=1e-6)
    # Now with binding box w0 <= 1: w0 = 1, w1 = 0.
    ub2 = np.array([1.0, 10.0])
    w2 = qp_box_eq_solve(P, f, E, d, lb, ub2)
    np.testing.assert_allclose(w2, [1.0, 0.0], atol=1e-5)


def test_rel_state_bounds_dx():
    """x_bounds_rel group: |x_{t+1} - x_t| <= bound on the solution."""
    A, B, c, Q, Qd, R, x0, xd = _random_problem(T=8, n=3, m=2, seed=7)
    prob = lqr_ops.build_tracking_problem(A, B, c, Q, Qd, R, x0, xd)
    T, n, m = B.shape
    lim = 0.15
    bounds = admm_ops.BoxBounds(
        dx=jnp.stack([jnp.full((T, n), -lim), jnp.full((T, n), lim)]))
    sol = admm_ops.solve_boxed_tvlqr(prob, bounds, n_phys=n, rho=5.0,
                                     iters=200)
    dx = np.asarray(sol.x_trj[1:] - sol.x_trj[:-1])
    assert float(sol.r_primal) < 5e-3
    assert np.all(np.abs(dx) <= lim + 1e-2)
    # And it must differ from the unconstrained solution (bound binds).
    x_unc, _, _ = lqr_ops.lqr_solve(prob)
    dx_unc = np.asarray(x_unc[1:] - x_unc[:-1])
    assert np.max(np.abs(dx_unc)) > lim + 0.05


def test_rel_input_bounds_du_delta_mode():
    """u_bounds_rel group in the Δu-augmented problem:
    |u_t - u_{t-1}| <= bound (u_{-1} = x0[idx])."""
    A, B, c, Q, Qd, R, x0, xd = _random_problem(T=8, n=3, m=2, seed=8)
    idx = jnp.array([0, 2], dtype=jnp.int32)
    prob = lqr_ops.build_delta_u_problem(A, B, c, Q, Qd, R, x0, xd, idx)
    T, m = 8, 2
    lim = 0.1
    bounds = admm_ops.BoxBounds(
        du=jnp.stack([jnp.full((T, m), -lim), jnp.full((T, m), lim)]))
    sol = admm_ops.solve_boxed_tvlqr(
        prob, bounds, n_phys=3, idx_w=jnp.arange(3, 5), rho=5.0, iters=200)
    u = np.asarray(sol.u_trj)
    u_prev = np.concatenate([np.asarray(x0)[np.asarray(idx)][None],
                             u[:-1]], axis=0)
    assert np.all(np.abs(u - u_prev) <= lim + 1e-2)


def test_rel_input_bounds_plain_u_mode():
    """u_bounds_rel in PLAIN-u mode (no Δu cost): the prev-u-augmented
    problem (ops/lqr.build_prev_u_tracking_problem) must enforce
    |u_t - u_{t-1}| <= lim for t >= 1 INSIDE the QP.  The reference intends
    this (tv_lqr.py:121-124 adds the box unconditionally) but its non-Δu
    branch never ties dut to u_t - u_{t-1} (tv_lqr.py:98-105), so there the
    bound binds a free slack — a quirk fixed here.  Cross-checked against
    the native active-set oracle on the condensed (equality-eliminated) QP.
    """
    from irs_mpc_tpu.native import qp_ineq_solve_grad
    A, B, c, Q, Qd, R, x0, xd = _random_problem(T=8, n=3, m=2, seed=11)
    prob = lqr_ops.build_prev_u_tracking_problem(A, B, c, Q, Qd, R, x0, xd)
    T, n, m = B.shape
    lim = 0.12

    # du box with the t=0 row unconstrained (no predecessor input).
    big = 3e4
    du_lb = np.full((T, m), -lim); du_lb[0] = -big
    du_ub = np.full((T, m), lim); du_ub[0] = big
    bounds = admm_ops.BoxBounds(
        du=jnp.stack([jnp.asarray(du_lb, jnp.float32),
                      jnp.asarray(du_ub, jnp.float32)]))
    sol = admm_ops.solve_boxed_tvlqr(
        prob, bounds, n_phys=n, idx_w=jnp.arange(n, n + m), rho=5.0,
        iters=300)
    u = np.asarray(sol.u_trj)
    du = u[1:] - u[:-1]
    assert float(sol.r_primal) < 5e-3
    assert np.all(np.abs(du) <= lim + 1e-2)

    # The bound must actually bind: the unconstrained optimum violates it.
    u_unc = np.asarray(lqr_ops.lqr_solve(prob)[1])
    assert np.max(np.abs(u_unc[1:] - u_unc[:-1])) > lim + 0.05

    # Condensed f64 oracle: x-stack = S u + s0, inequalities on du rows.
    A64, B64, c64 = [np.asarray(a, np.float64) for a in (A, B, c)]
    Q64, Qd64, R64 = [np.asarray(a, np.float64) for a in (Q, Qd, R)]
    x064, xd64 = np.asarray(x0, np.float64), np.asarray(xd, np.float64)
    nv = T * m
    S = np.zeros(((T + 1) * n, nv))
    s0 = np.zeros((T + 1) * n)
    s0[:n] = x064
    for t in range(T):
        r = (t + 1) * n
        S[r:r + n] = A64[t] @ S[r - n:r]
        S[r:r + n, t * m:(t + 1) * m] += B64[t]
        s0[r:r + n] = A64[t] @ s0[r - n:r] + c64[t]
    Qbig = np.zeros(((T + 1) * n, (T + 1) * n))
    for t in range(T):
        Qbig[t * n:(t + 1) * n, t * n:(t + 1) * n] = Q64
    Qbig[T * n:, T * n:] = Qd64
    Rbig = np.kron(np.eye(T), R64)
    e0 = s0 - xd64.reshape(-1)
    H = S.T @ Qbig @ S + Rbig
    f = S.T @ Qbig @ e0
    rows = []
    rhs = []
    for t in range(1, T):
        D = np.zeros((m, nv))
        D[:, t * m:(t + 1) * m] = np.eye(m)
        D[:, (t - 1) * m:t * m] = -np.eye(m)
        rows += [D, -D]
        rhs += [np.full(m, lim), np.full(m, lim)]
    C = np.vstack(rows)
    d = np.concatenate(rhs)
    u_or, _, _ = qp_ineq_solve_grad(2 * H, 2 * f, C, d)
    np.testing.assert_allclose(u.reshape(-1), u_or, rtol=2e-2, atol=2e-2)


def test_rel_input_bounds_plain_u_solver_path():
    """End-to-end IrsMpc with u_bounds_rel on a plain-u system: the accepted
    trajectory's inputs respect the rel box for t >= 1 even when it binds."""
    from irs_mpc_tpu import IrsMpc, IrsMpcParams, SmoothingConfig
    from irs_mpc_tpu.models.base import System

    # Double integrator; aggressive goal so unconstrained du would be large.
    h = 0.1

    def step(x, u):
        return jnp.array([x[0] + h * x[1], x[1] + h * u[0]])

    sys_ = System(name="dint", dim_x=2, dim_u=1, h=h, step=step)
    T = 20
    lim = 0.4
    params = IrsMpcParams(
        Q=np.diag([10.0, 1.0]), Qd=np.diag([50.0, 5.0]), R=np.eye(1) * 1e-3,
        x0=np.zeros(2), xd_trj=np.tile([1.0, 0.0], (T + 1, 1)),
        u_trj_init=np.zeros((T, 1)),
        u_bounds_rel=np.array([[-lim], [lim]]),
        gradient_mode="exact", admm_iters=120, admm_rho=2.0,
        smoothing=SmoothingConfig(num_samples=8))
    solver = IrsMpc(sys_, params)
    solver.iterate(4, verbose=False)
    u = np.asarray(solver.u_trj)
    du = u[1:] - u[:-1]
    assert np.all(np.abs(du) <= lim + 1e-2), np.abs(du).max()
    # The constraint must have been active at some point (task demands it).
    assert np.max(np.abs(du)) > 0.5 * lim
    # And the solve made real progress toward the goal.
    assert solver.cost < 0.5 * solver.cost_lst[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_active_set_oracle_kkt_and_gradient(seed):
    """qp_ineq_solve_grad: KKT optimality on feasible random QPs and the
    analytic active-set directional derivative vs finite differences."""
    from irs_mpc_tpu.native import qp_ineq_solve_grad
    rng = np.random.RandomState(seed)
    for _ in range(10):
        n, m = 6, 12
        A = rng.randn(n, n)
        P = A @ A.T + np.eye(n)
        q = rng.randn(n)
        C = rng.randn(m, n)
        d = C @ rng.randn(n) + np.abs(rng.randn(m)) * 0.3  # feasible
        x, lam, _ = qp_ineq_solve_grad(P, q, C, d)
        assert (C @ x - d).max() < 1e-6
        assert np.all(lam >= -1e-9)
        assert np.linalg.norm(P @ x + q + C.T @ lam) < 1e-5
        dd = rng.randn(m)
        eps = 1e-6
        x2, _, _ = qp_ineq_solve_grad(P, q, C, d + eps * dd)
        _, _, dx = qp_ineq_solve_grad(P, q, C, d, dd=dd)
        err = np.linalg.norm((x2 - x) / eps - dx) / max(1.0,
                                                        np.linalg.norm(dx))
        assert err < 1e-4, err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_over_relaxation_matches_oracle_at_half_iters(seed):
    """ADMM over-relaxation (a=1.6, Boyd §3.4.3): 15 over-relaxed sweeps
    must match the f64 oracle within the tolerance the plain scheme needs
    30 sweeps for — the latency-halving knob used by the hot contact
    drivers (each sweep is serial over the horizon)."""
    A, B, c, Q, Qd, R, x0, xd = _random_problem(T=6, n=3, m=2, seed=seed)
    prob = lqr_ops.build_tracking_problem(A, B, c, Q, Qd, R, x0, xd)
    T, n, m = B.shape
    u_lb, u_ub = -0.3 * np.ones(m), 0.3 * np.ones(m)
    x_lb, x_ub = -2.0 * np.ones(n), 2.0 * np.ones(n)
    bounds = admm_ops.BoxBounds(
        x=jnp.stack([jnp.tile(jnp.asarray(x_lb, jnp.float32), (T + 1, 1)),
                     jnp.tile(jnp.asarray(x_ub, jnp.float32), (T + 1, 1))]),
        u=jnp.stack([jnp.tile(jnp.asarray(u_lb, jnp.float32), (T, 1)),
                     jnp.tile(jnp.asarray(u_ub, jnp.float32), (T, 1))]))
    x_or, u_or = _oracle_solve(prob, x_lb, x_ub, u_lb, u_ub)

    plain30 = admm_ops.solve_boxed_tvlqr(prob, bounds, n_phys=n, rho=5.0,
                                         iters=30)
    over15 = admm_ops.solve_boxed_tvlqr(prob, bounds, n_phys=n, rho=5.0,
                                        iters=15, over_relax=1.6)
    e_plain = np.max(np.abs(np.asarray(plain30.u_trj) - u_or))
    e_over = np.max(np.abs(np.asarray(over15.u_trj) - u_or))
    assert e_over <= max(1.5 * e_plain, 2e-2), (e_over, e_plain)
    # Bounds still respected.
    assert np.all(np.asarray(over15.u_trj) <= u_ub + 1e-2)
    assert np.all(np.asarray(over15.u_trj) >= u_lb - 1e-2)
    # a=1.0 is exactly the plain scheme (same lax.scan trace).
    plain_explicit = admm_ops.solve_boxed_tvlqr(
        prob, bounds, n_phys=n, rho=5.0, iters=30, over_relax=1.0)
    np.testing.assert_array_equal(np.asarray(plain30.u_trj),
                                  np.asarray(plain_explicit.u_trj))


def test_factored_admm_matches_generic_path():
    """The factored sweep loop (one Riccati factorization + per-sweep
    linear re-solves; the sequential default) must agree with the
    generic full-solve-per-sweep path (kept for the assoc backend) to
    backend-numerics tolerance."""
    for seed in range(2):
        A, B, c, Q, Qd, R, x0, xd = _random_problem(T=6, n=3, m=2, seed=seed)
        prob = lqr_ops.build_tracking_problem(A, B, c, Q, Qd, R, x0, xd)
        T, n, m = B.shape
        bounds = admm_ops.BoxBounds(
            u=jnp.stack([jnp.full((T, m), -0.3), jnp.full((T, m), 0.3)]))
        fast = admm_ops.solve_boxed_tvlqr(prob, bounds, n_phys=n, rho=5.0,
                                          iters=120)
        slow = admm_ops.solve_boxed_tvlqr(prob, bounds, n_phys=n, rho=5.0,
                                          iters=120, parallel=True)
        eu = float(jnp.max(jnp.abs(fast.u_trj - slow.u_trj)))
        assert eu < 2e-3, (seed, eu)
        assert float(fast.r_primal) < 1e-3


def test_all_none_bounds_degenerates_to_lqr():
    """BoxBounds() with every kind disabled must solve the unconstrained
    TV-LQR (previously the residual stack over zero enabled kinds raised)."""
    import numpy as np
    from irs_mpc_tpu.ops import admm as admm_ops
    from irs_mpc_tpu.ops import lqr as lqr_ops

    rng = np.random.RandomState(2)
    T, n, m = 5, 3, 2
    A = jnp.asarray(rng.randn(T, n, n) * 0.2 + np.eye(n), jnp.float32)
    B = jnp.asarray(rng.randn(T, n, m) * 0.5, jnp.float32)
    c = jnp.asarray(rng.randn(T, n) * 0.1, jnp.float32)
    prob = lqr_ops.build_tracking_problem(
        A, B, c, jnp.eye(n), jnp.eye(n) * 3, jnp.eye(m),
        jnp.asarray(rng.randn(n), jnp.float32), jnp.zeros((T + 1, n)))
    sol = admm_ops.solve_boxed_tvlqr(prob, admm_ops.BoxBounds(), n_phys=n)
    x_ref, u_ref, _ = lqr_ops.lqr_solve(prob)
    np.testing.assert_allclose(sol.u_trj, u_ref, atol=1e-5)
    assert float(sol.r_primal) == 0.0


@pytest.mark.parametrize("kinds", [("x", "u"), ("dx",), ("u", "du"),
                                   ("x", "u", "dx", "du")])
def test_all_bound_kinds_match_dense_oracle(kinds):
    """The XLA sweep loop at convergence vs the dense f64 oracle that
    stacks every bound kind into one QP (native.boxed_tvlqr_oracle, also
    the reference chip_smoke.py holds the GPU kernel to)."""
    from irs_mpc_tpu.native import boxed_tvlqr_oracle

    A, B, c, Q, Qd, R, x0, xd = _random_problem(T=6, n=3, m=2, seed=4)
    T, n, m = B.shape
    if "du" in kinds:
        prob = lqr_ops.build_delta_u_problem(A, B, c, Q, Qd, R, x0, xd,
                                             jnp.arange(m))
        idx_w = np.arange(n, n + m)
    else:
        prob = lqr_ops.build_tracking_problem(A, B, c, Q, Qd, R, x0, xd)
        idx_w = None
    box = lambda rows, w, v: jnp.stack([jnp.full((rows, w), -v),
                                        jnp.full((rows, w), v)])
    bounds = admm_ops.BoxBounds(
        x=box(T + 1, n, 2.0) if "x" in kinds else None,
        u=box(T, m, 0.3) if "u" in kinds else None,
        dx=box(T, n, 0.4) if "dx" in kinds else None,
        du=box(T, m, 0.2) if "du" in kinds else None)
    sol = admm_ops.solve_boxed_tvlqr(prob, bounds, n_phys=n, idx_w=idx_w,
                                     rho=5.0, iters=400, over_relax=1.6)
    x_or, u_or = boxed_tvlqr_oracle(prob, bounds, n_phys=n, idx_w=idx_w)
    assert float(sol.r_primal) < 1e-3
    np.testing.assert_allclose(sol.u_trj, u_or, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(sol.x_trj, x_or, rtol=5e-3, atol=5e-3)
