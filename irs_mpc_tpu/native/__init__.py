"""Native (C++) components: host-side numerical oracles.

Build-on-demand via g++ (no external deps); loaded through ctypes.  The
compiled library is cached next to the sources.  These fill the role the
reference delegates to external native projects (Drake's OSQP/Gurobi for the
QP, ``quasistatic_simulator_py`` for contact — see SURVEY.md §2.4) while the
production compute path stays on-device in JAX/XLA.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_LIB_PATH = _DIR / "libirsnative.so"
_SOURCES = ["qp_ref.cpp"]
_lib = None


def _build() -> Path:
    srcs = [str(_DIR / s) for s in _SOURCES]
    newest_src = max(os.path.getmtime(s) for s in srcs)
    if not _LIB_PATH.exists() or os.path.getmtime(_LIB_PATH) < newest_src:
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
               "-o", str(_LIB_PATH)] + srcs
        subprocess.run(cmd, check=True, capture_output=True)
    return _LIB_PATH


def _get_lib():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(_build()))
        _lib.qp_box_eq_solve.restype = ctypes.c_int
        _lib.qp_box_eq_solve.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double)]
    return _lib


def qp_box_eq_solve(P, f, E, d, lb, ub, rho: float = 1.0,
                    iters: int = 4000, tol: float = 1e-10) -> np.ndarray:
    """Solve min 1/2 w'Pw + f'w s.t. Ew = d, lb <= w <= ub (C++ oracle)."""
    P = np.ascontiguousarray(P, np.float64)
    f = np.ascontiguousarray(f, np.float64)
    E = np.ascontiguousarray(E, np.float64)
    d = np.ascontiguousarray(d, np.float64)
    lb = np.ascontiguousarray(lb, np.float64)
    ub = np.ascontiguousarray(ub, np.float64)
    nv = f.shape[0]
    ne = d.shape[0]
    assert P.shape == (nv, nv) and E.shape == (ne, nv)
    w = np.zeros(nv, np.float64)
    cd = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    ret = _get_lib().qp_box_eq_solve(
        nv, ne, cd(P), cd(f), cd(E), cd(d), cd(lb), cd(ub),
        ctypes.c_double(rho), iters, ctypes.c_double(tol), cd(w))
    if ret != 0:
        raise RuntimeError("native QP solver: KKT factorization failed")
    return w


def qp_ineq_solve_grad(P, q, C, d, dP=None, dq=None, dC=None, dd=None,
                       rho: float = 1.0, iters: int = 8000,
                       tol: float = 1e-11, act_tol: float = 1e-7):
    """Native oracle: solve min 1/2 x'Px + q'x s.t. Cx <= d, and return the
    ANALYTIC directional derivative dx for the tangent (dP, dq, dC, dd) via
    the active-constraint KKT system — the reference's
    ``grad_from_active_constraints`` semantics
    (``quasistatic_dynamics.py:158-162``).  Returns (x, lam, dx)."""
    lib = _get_lib()
    if not hasattr(lib, "_ineq_configured"):
        lib.qp_ineq_solve_grad.restype = ctypes.c_int
        lib.qp_ineq_solve_grad.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.POINTER(ctypes.c_double)] * 8
            + [ctypes.c_double, ctypes.c_int, ctypes.c_double,
               ctypes.c_double]
            + [ctypes.POINTER(ctypes.c_double)] * 3)
        lib._ineq_configured = True
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    C = np.ascontiguousarray(C, np.float64)
    d = np.ascontiguousarray(d, np.float64)
    n, m = q.shape[0], d.shape[0]
    z = lambda a, shape: (np.zeros(shape, np.float64) if a is None
                          else np.ascontiguousarray(a, np.float64))
    dP, dq = z(dP, (n, n)), z(dq, n)
    dC, dd = z(dC, (m, n)), z(dd, m)
    assert P.shape == (n, n) and C.shape == (m, n)
    x = np.zeros(n, np.float64)
    lam = np.zeros(m, np.float64)
    dx = np.zeros(n, np.float64)
    cd = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    # Escalate the ADMM budget / step size on slow-converging instances
    # before declaring failure (a failure then means infeasible in practice).
    for it_k, rho_k in ((iters, rho), (25 * iters, rho), (25 * iters,
                                                          10 * rho)):
        ret = lib.qp_ineq_solve_grad(
            n, m, cd(P), cd(q), cd(C), cd(d), cd(dP), cd(dq), cd(dC), cd(dd),
            ctypes.c_double(rho_k), it_k, ctypes.c_double(tol),
            ctypes.c_double(act_tol), cd(x), cd(lam), cd(dx))
        if ret != 2:
            break
    if ret == 1:
        raise RuntimeError("native QP oracle: KKT factorization failed")
    if ret == 2:
        raise RuntimeError("native QP oracle: active-set refinement did not "
                           "converge (problem likely infeasible)")
    return x, lam, dx


def boxed_tvlqr_oracle(prob, bounds, n_phys: int, idx_w=None,
                       iters: int = 20000):
    """Dense f64 reference for ops/admm.solve_boxed_tvlqr: the whole boxed
    TV-LQR QP (all four bound kinds) stacked into one box-and-equality QP
    and solved by :func:`qp_box_eq_solve`.

    Variables w = [x_0..x_T, u_0..u_{T-1}, s_dx (if dx), s_du (if du)] with
    equalities x_0 = x0, the dynamics, s_dx_t = x_{t+1} - x_t (physical
    block) and s_du_t = u_t - x_t[idx_w].  ``prob`` is ops/lqr.LqrProblem,
    ``bounds`` ops/admm.BoxBounds.  Returns (x (T+1, n), u (T, m))."""
    f64 = lambda a: np.asarray(a, np.float64)
    A, B, c = f64(prob.A), f64(prob.B), f64(prob.c)
    T, n, m = B.shape
    has_dx, has_du = bounds.dx is not None, bounds.du is not None
    nx, nu = (T + 1) * n, T * m
    o_dx = nx + nu
    o_du = o_dx + (T * n_phys if has_dx else 0)
    nv = o_du + (T * m if has_du else 0)
    xi = lambda t: slice(t * n, (t + 1) * n)
    ui = lambda t: slice(nx + t * m, nx + (t + 1) * m)

    H = np.zeros((nv, nv))
    f = np.zeros(nv)
    for t in range(T):
        N = f64(prob.N[t])
        H[xi(t), xi(t)] += 2 * f64(prob.Q[t])
        H[ui(t), ui(t)] += 2 * f64(prob.R[t])
        H[xi(t), ui(t)] += 2 * N
        H[ui(t), xi(t)] += 2 * N.T
        f[xi(t)] += 2 * f64(prob.q[t])
        f[ui(t)] += 2 * f64(prob.r[t])
    H[xi(T), xi(T)] += 2 * f64(prob.Qf)
    f[xi(T)] += 2 * f64(prob.qf)

    rows = []
    def eq(coeffs, rhs):
        row = np.zeros(nv)
        for sl, val in coeffs:
            row[sl] += val
        rows.append((row, rhs))

    for i in range(n):
        eq([(i, 1.0)], f64(prob.x0)[i])
    for t in range(T):
        for i in range(n):
            coeffs = [(slice(t * n, (t + 1) * n), A[t, i]),
                      (slice(nx + t * m, nx + (t + 1) * m), B[t, i]),
                      ((t + 1) * n + i, -1.0)]
            eq(coeffs, -c[t, i])
        if has_dx:
            for i in range(n_phys):
                eq([(o_dx + t * n_phys + i, 1.0), ((t + 1) * n + i, -1.0),
                    (t * n + i, 1.0)], 0.0)
        if has_du:
            w_idx = np.asarray(idx_w)
            for j in range(m):
                eq([(o_du + t * m + j, 1.0), (nx + t * m + j, -1.0),
                    (t * n + int(w_idx[j]), 1.0)], 0.0)
    E = np.stack([r for r, _ in rows])
    d = np.asarray([v for _, v in rows])

    big = 1e9
    lb, ub = np.full(nv, -big), np.full(nv, big)
    if bounds.x is not None:
        bx = f64(bounds.x)
        for t in range(1, T + 1):      # x_0 is pinned by its equality
            lb[t * n:t * n + n_phys] = bx[0, t]
            ub[t * n:t * n + n_phys] = bx[1, t]
    if bounds.u is not None:
        bu = f64(bounds.u)
        lb[nx:nx + nu], ub[nx:nx + nu] = bu[0].ravel(), bu[1].ravel()
    if has_dx:
        b = f64(bounds.dx)
        lb[o_dx:o_du], ub[o_dx:o_du] = b[0].ravel(), b[1].ravel()
    if has_du:
        b = f64(bounds.du)
        lb[o_du:], ub[o_du:] = b[0].ravel(), b[1].ravel()
    w = qp_box_eq_solve(H, f, E, d, lb, ub, rho=10.0, iters=iters,
                        tol=1e-12)
    return w[:nx].reshape(T + 1, n), w[nx:nx + nu].reshape(T, m)
