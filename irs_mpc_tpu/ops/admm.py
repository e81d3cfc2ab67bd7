"""Constrained TV-LQR: on-device boxed QP via ADMM with Riccati inner solves.

Replaces the reference's Drake MathematicalProgram + OSQP/Gurobi QP
(``/root/reference/irs_lqr/tv_lqr.py:30-145``) — including all four bound
kinds (absolute/relative on state and input, ``tv_lqr.py:113-124``) and the
Δu-cost position-controlled mode (``tv_lqr.py:98-110``) — with a fixed-
iteration ADMM scheme whose x-update is an equality-constrained QP solved
exactly by the Riccati scan (ops/lqr.py).  Everything is jit/vmap-compatible:
no data-dependent control flow, fixed iteration count.

Splitting: let ξ = (x_{0:T}, u_{0:T-1}) constrained to the dynamics manifold.
The box-constrained quantities are stage-affine functions of ξ *on that
manifold*:
    s_x  = x_t,                 s_u  = u_t,
    s_dx = x_{t+1} - x_t = (A_t - I) x_t + B_t u_t + c_t,
    s_du = u_t - w_t            (w = prev-input component of the augmented
                                 state, see lqr.build_delta_u_problem).
ADMM alternates: (1) ξ-update = Riccati solve of the stage cost + ρ-penalties
pulling each s toward (z - y); (2) z = clip(s + y, lb, ub); (3) y += s - z.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import lqr as lqr_ops

Array = jax.Array


class BoxBounds(NamedTuple):
    """Per-stage box bounds; any member may be None (disabled at trace time).

    Shapes: x (2, T+1, n) — lb/ub on states incl. final;
            u (2, T, m); dx (2, T, n); du (2, T, m).
    """
    x: Optional[Array] = None
    u: Optional[Array] = None
    dx: Optional[Array] = None
    du: Optional[Array] = None


class AdmmSolution(NamedTuple):
    x_trj: Array          # (T+1, n) — augmented state if Δu mode
    u_trj: Array          # (T, m)
    # Feedback gains and value function of the FINAL ADMM sweep.
    gains: lqr_ops.LqrGains
    r_primal: Array       # final primal residual (inf-norm)
    r_dual: Array         # final dual residual  (inf-norm)


def _penalized_problem(prob: lqr_ops.LqrProblem, bounds: BoxBounds,
                       z, y, rho: float, n_phys: int,
                       idx_w: Optional[Array]):
    """Add the ADMM quadratic penalties to the stage cost matrices.

    ``n_phys`` is the physical state dim (penalties on x/dx act on the first
    n_phys components of a possibly-augmented state); ``idx_w`` gives the
    augmented prev-input block for the du penalty (None if du disabled).
    """
    T, n, m = prob.B.shape
    Q, R, N = prob.Q, prob.R, prob.N
    q, r = prob.q, prob.r
    Qf, qf = prob.Qf, prob.qf
    eyen = jnp.eye(n, dtype=prob.A.dtype)

    if bounds.x is not None:
        vx = z.x - y.x                      # (T+1, n_phys)
        sel = eyen[:n_phys]                 # (n_phys, n)
        Q = Q + rho * (sel.T @ sel)[None]
        q = q.at[:, :n_phys].add(-rho * vx[:-1])
        Qf = Qf + rho * (sel.T @ sel)
        qf = qf.at[:n_phys].add(-rho * vx[-1])

    if bounds.u is not None:
        vu = z.u - y.u
        R = R + rho * jnp.eye(m, dtype=R.dtype)[None]
        r = r - rho * vu

    if bounds.dx is not None:
        vdx = z.dx - y.dx                   # (T, n_phys)
        D = prob.A[:, :n_phys, :] - eyen[None, :n_phys, :]  # (T, n_phys, n)
        Bp = prob.B[:, :n_phys, :]                          # (T, n_phys, m)
        cp = prob.c[:, :n_phys]
        e = cp - vdx
        Q = Q + rho * jnp.swapaxes(D, 1, 2) @ D
        R = R + rho * jnp.swapaxes(Bp, 1, 2) @ Bp
        N = N + rho * jnp.swapaxes(D, 1, 2) @ Bp
        q = q + rho * jnp.einsum("tij,ti->tj", D, e)
        r = r + rho * jnp.einsum("tij,ti->tj", Bp, e)

    if bounds.du is not None:
        # s_du = u - w where w = x[idx_w] (augmented prev-input block).
        vdu = z.du - y.du                   # (T, m)
        W = jnp.zeros((m, n), dtype=prob.A.dtype)
        W = W.at[jnp.arange(m), idx_w].set(1.0)   # w = W x
        # rho * || u - W x - v ||^2
        Q = Q + rho * (W.T @ W)[None]
        R = R + rho * jnp.eye(m, dtype=R.dtype)[None]
        N = N - rho * jnp.broadcast_to(W.T, (T, n, m))
        q = q + rho * jnp.einsum("ij,tj->ti", W.T, vdu)
        r = r - rho * vdu

    return prob._replace(Q=Q, R=R, N=N, q=q, r=r, Qf=Qf, qf=qf)


def _penalized_linear_terms(prob: lqr_ops.LqrProblem, bounds: BoxBounds,
                            z, y, rho: float, n_phys: int,
                            idx_w: Optional[Array]):
    """The (q, r, qf) of :func:`_penalized_problem` alone.

    The z/y consensus variables enter ONLY these affine terms (every
    quadratic penalty is rho * S'S for a constant selector S), which is what
    lets the ADMM sweep loop reuse one Riccati factorization
    (lqr.riccati_factorize) and re-solve just the linear recursion."""
    T, n, m = prob.B.shape
    q, r, qf = prob.q, prob.r, prob.qf

    if bounds.x is not None:
        vx = z.x - y.x
        q = q.at[:, :n_phys].add(-rho * vx[:-1])
        qf = qf.at[:n_phys].add(-rho * vx[-1])

    if bounds.u is not None:
        r = r - rho * (z.u - y.u)

    if bounds.dx is not None:
        vdx = z.dx - y.dx
        D = prob.A[:, :n_phys, :] - jnp.eye(
            n, dtype=prob.A.dtype)[None, :n_phys, :]
        Bp = prob.B[:, :n_phys, :]
        e = prob.c[:, :n_phys] - vdx
        q = q + rho * jnp.einsum("tij,ti->tj", D, e)
        r = r + rho * jnp.einsum("tij,ti->tj", Bp, e)

    if bounds.du is not None:
        vdu = z.du - y.du
        W = jnp.zeros((m, n), dtype=prob.A.dtype)
        W = W.at[jnp.arange(m), idx_w].set(1.0)
        q = q + rho * jnp.einsum("ij,tj->ti", W.T, vdu)
        r = r - rho * vdu

    return q, r, qf


class _SVals(NamedTuple):
    x: Array
    u: Array
    dx: Array
    du: Array


def _stage_values(prob, x_trj, u_trj, n_phys, idx_w) -> _SVals:
    xs = x_trj[:, :n_phys]
    dx = xs[1:] - xs[:-1]
    if idx_w is not None:
        du = u_trj - x_trj[:-1][:, idx_w]
    else:
        du = jnp.zeros_like(u_trj)
    return _SVals(x=xs, u=u_trj, dx=dx, du=du)


def kernel_unsupported(bounds: BoxBounds, n_phys: int, n: int, m: int,
                       idx_w, parallel: bool, platform: str) -> Optional[str]:
    """Why the whole-loop GPU kernel (ops/pallas_admm.py) cannot run this
    problem, or None when it can.  The rule:

    * the platform is a GPU — the kernel is compiled by Triton for the card;
      on the CPU there is no kernel, and XLA's loops are the program;
    * ``parallel`` is off — the associative-scan sweeps stay in XLA;
    * at least one bound kind is enabled (no bounds is plain TV-LQR);
    * n and m are at most ``pallas_admm.MAX_DIM`` (each step keeps a few
      (n, n) tiles in registers);
    * du bounds use the augmentation layout the solver builds: a concrete
      (not traced) ``idx_w == arange(n_phys, n)`` with n - n_phys == m.
    """
    from .pallas_admm import MAX_DIM
    if platform != "gpu":
        return f"the kernel runs only on a GPU, not on {platform!r}"
    if parallel:
        return "parallel (associative-scan) sweeps run in XLA"
    if all(b is None for b in bounds):
        return "no bound kind is enabled"
    if max(n, m) > MAX_DIM:
        return f"n={n}, m={m} exceed the kernel's width {MAX_DIM}"
    if bounds.du is not None:
        if isinstance(idx_w, jax.core.Tracer):
            return "du bounds with a traced idx_w"
        if (idx_w is None or n - n_phys != m or not np.array_equal(
                np.asarray(idx_w), np.arange(n_phys, n))):
            return "du bounds need idx_w == arange(n_phys, n)"
    return None


def solve_boxed_tvlqr(prob: lqr_ops.LqrProblem,
                      bounds: BoxBounds,
                      n_phys: int,
                      idx_w: Optional[Array] = None,
                      rho: float = 1.0,
                      iters: int = 60,
                      parallel: bool = False,
                      over_relax: float = 1.0,
                      kernel: Optional[bool] = None) -> AdmmSolution:
    """Solve the boxed TV-LQR QP.  ``prob`` may be Δu-augmented (then
    ``idx_w`` points at the prev-input block and ``n_phys`` < n).

    Fixed ``iters`` ADMM sweeps; each sweep is one Riccati backward pass +
    linear rollout.  Returns the solution with final residuals so callers can
    monitor convergence without breaking jit.

    ``over_relax`` in [1, 2): standard ADMM over-relaxation — the z/y updates
    see s_hat = a*s + (1-a)*z_prev instead of s (Boyd et al. §3.4.3).  a=1.6
    typically halves the sweeps needed for a given residual; a=1.0 recovers
    plain ADMM exactly.  Each sweep is serial over the horizon, so fewer
    sweeps is a direct latency win for the trajectory-QP phase.

    This is the one place that picks the implementation.  ``kernel=None``
    runs the whole-loop GPU kernel (ops/pallas_admm.py) wherever
    :func:`kernel_unsupported` allows it and XLA's loops elsewhere;
    ``kernel=True`` demands the kernel and raises where it cannot run;
    ``kernel=False`` forces the XLA loops.
    """
    T, n, m = prob.B.shape
    f32 = prob.A.dtype

    # Degenerate all-None bounds: the QP is the unconstrained TV-LQR.
    if all(b is None for b in bounds):
        if kernel:
            raise ValueError("ADMM kernel requested, but no bound kind is "
                             "enabled")
        x_trj, u_trj, gains = lqr_ops.lqr_solve(prob, parallel=parallel)
        zero = jnp.zeros((), f32)
        return AdmmSolution(x_trj=x_trj, u_trj=u_trj, gains=gains,
                            r_primal=zero, r_dual=zero)

    why_not = kernel_unsupported(bounds, n_phys, n, m, idx_w, parallel,
                                 jax.default_backend())
    if kernel and why_not is not None:
        raise ValueError(f"ADMM kernel requested, but {why_not}")
    if kernel is None:
        kernel = why_not is None
    if kernel:
        return solve_boxed_tvlqr_kernel(prob, bounds, n_phys, idx_w, rho,
                                        iters, over_relax)
    return _solve_boxed_xla(prob, bounds, n_phys, idx_w, rho, iters,
                            parallel, over_relax)


def _clip_or(s, b):
    return s if b is None else jnp.clip(s, b[0], b[1])


def _admm_init(prob, bounds, n_phys, idx_w, parallel):
    """z at the unconstrained solution projected onto the boxes, y = 0."""
    T, n, m = prob.B.shape
    f32 = prob.A.dtype
    x0_trj, u0_trj, gains0 = lqr_ops.lqr_solve(prob, parallel=parallel)
    s0 = _stage_values(prob, x0_trj, u0_trj, n_phys, idx_w)
    z0 = _SVals(*(_clip_or(getattr(s0, kd), getattr(bounds, kd))
                  for kd in _SVals._fields))
    y0 = _SVals(x=jnp.zeros((T + 1, n_phys), f32),
                u=jnp.zeros((T, m), f32),
                dx=jnp.zeros((T, n_phys), f32),
                du=jnp.zeros((T, m), f32))
    return z0, y0, (x0_trj, u0_trj, gains0)


def _residuals(prob, bounds, x_trj, u_trj, z, z_prev, rho, n_phys, idx_w):
    """Primal/dual residuals over the ENABLED bound kinds only: a disabled
    kind's z tracks the raw stage value (_clip_or's pass-through), so
    including it would leak unconstrained solution movement into the dual
    residual.  ``z``/``z_prev`` map kind -> array."""
    s = _stage_values(prob, x_trj, u_trj, n_phys, idx_w)
    enabled = [kd for kd in _SVals._fields if getattr(bounds, kd) is not None]
    r_primal = jnp.max(jnp.stack([
        jnp.max(jnp.abs(getattr(s, kd) - z[kd])) for kd in enabled]))
    r_dual = jnp.max(jnp.stack([
        rho * jnp.max(jnp.abs(z[kd] - z_prev[kd])) for kd in enabled]))
    return r_primal, r_dual


def solve_boxed_tvlqr_kernel(prob: lqr_ops.LqrProblem, bounds: BoxBounds,
                             n_phys: int, idx_w: Optional[Array] = None,
                             rho: float = 1.0, iters: int = 60,
                             over_relax: float = 1.0,
                             interpret: bool = False) -> AdmmSolution:
    """The whole ADMM loop as one GPU kernel (ops/pallas_admm.py); same
    initialization, sweeps and residuals as the XLA path.  Callers go
    through :func:`solve_boxed_tvlqr`; ``interpret=True`` runs the kernel's
    Pallas interpreter (tests on the CPU)."""
    from .pallas_admm import boxed_admm_kernel
    z0, y0, _ = _admm_init(prob, bounds, n_phys, idx_w, parallel=False)
    # The quadratic penalties are sweep-invariant: add them once here.
    pen = _penalized_problem(prob, bounds, y0, y0, rho, n_phys, idx_w)
    x_trj, u_trj, K, k, P, p, z, zp = boxed_admm_kernel(
        pen, prob, bounds, z0, y0, n_phys, rho, iters, over_relax,
        interpret=interpret)
    r_primal, r_dual = _residuals(prob, bounds, x_trj, u_trj, z, zp, rho,
                                  n_phys, idx_w)
    return AdmmSolution(x_trj=x_trj, u_trj=u_trj,
                        gains=lqr_ops.LqrGains(K=K, k=k, P=P, p=p),
                        r_primal=r_primal, r_dual=r_dual)


def _solve_boxed_xla(prob, bounds, n_phys, idx_w, rho, iters, parallel,
                     over_relax) -> AdmmSolution:
    """The ADMM loop as XLA scans (the CPU path and the reference the
    kernel is tested against)."""
    z0, y0, init_sol = _admm_init(prob, bounds, n_phys, idx_w, parallel)
    a = jnp.asarray(over_relax, prob.A.dtype)

    # The quadratic penalties are sweep-invariant, so the Riccati
    # factorization (K, H, G, P) is computed ONCE; each sweep re-solves only
    # the affine recursion over the z/y-dependent (q, r, qf).  The assoc
    # (parallel-in-time) backend keeps the generic full-solve path — its
    # point is O(log T) depth per sweep, which a sequential linear
    # recursion would forfeit.
    if not parallel:
        pen0 = _penalized_problem(prob, bounds, z0, y0, rho, n_phys, idx_w)
        fac = lqr_ops.riccati_factorize(pen0)

    def x_update(z, y):
        if not parallel:
            q, r, qf = _penalized_linear_terms(prob, bounds, z, y, rho,
                                               n_phys, idx_w)
            pen = pen0._replace(q=q, r=r, qf=qf)
            gains = lqr_ops.riccati_linear(pen, fac)
            x_trj, u_trj = lqr_ops.lqr_rollout_linear(pen, gains)
            return x_trj, u_trj, gains
        pen = _penalized_problem(prob, bounds, z, y, rho, n_phys, idx_w)
        return lqr_ops.lqr_solve(pen, parallel=True)

    def sweep(carry, _):
        z, y, _, _ = carry
        x_trj, u_trj, gains = x_update(z, y)
        s = _stage_values(prob, x_trj, u_trj, n_phys, idx_w)
        # Over-relaxation: blend past z into the consensus target.
        sh = jax.tree.map(lambda ss, zz: a * ss + (1.0 - a) * zz, s, z)
        sy = jax.tree.map(lambda a_, b: a_ + b, sh, y)
        z_new = _SVals(*(_clip_or(getattr(sy, kd), getattr(bounds, kd))
                         for kd in _SVals._fields))
        y_new = jax.tree.map(lambda yy, ss, zz: yy + ss - zz, y, sh, z_new)
        return (z_new, y_new, (x_trj, u_trj, gains), z), None

    (z, y, (x_trj, u_trj, gains), z_prev), _ = jax.lax.scan(
        sweep, (z0, y0, init_sol, z0), None, length=iters)
    r_primal, r_dual = _residuals(prob, bounds, x_trj, u_trj, z._asdict(),
                                  z_prev._asdict(), rho, n_phys, idx_w)
    return AdmmSolution(x_trj=x_trj, u_trj=u_trj, gains=gains,
                        r_primal=r_primal, r_dual=r_dual)
