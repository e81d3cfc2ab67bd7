"""Time-varying LQR backward/forward passes.

Replaces the reference's per-call dense QP construction through Drake
MathematicalProgram + OSQP/Gurobi (``/root/reference/irs_lqr/tv_lqr.py:30-145``)
with on-device Riccati recursions:

* ``riccati_backward``     — sequential ``lax.scan`` (O(T) depth), exact.
* ``riccati_backward_assoc`` — ``lax.associative_scan`` (O(log T) depth),
  the parallel-in-time form (cf. "The Parallelization of Riccati Recursion",
  PAPERS.md), equivalent to the sequential pass (tested).
* ``lqr_solve``            — backward pass + affine rollout on the *linear*
  model (the unconstrained QP optimum).

The problem is expressed in a canonical stage form that subsumes every cost
mode of the reference (tracking cost, plain ``u'Ru``, Δu-cost via state
augmentation — ``tv_lqr.py:98-110``):

    min  sum_t [ x'Q_t x + u'R_t u + 2 x'N_t u + 2 q_t'x + 2 r_t'u ]
         + x_T'Q_T x_T + 2 q_T'x_T
    s.t. x_{t+1} = A_t x_t + B_t u_t + c_t,  x_0 given.

(Note: *no* 1/2 factors, matching the reference's cost convention
``irs_lqr.py:121-137``.)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .linalg import solve_spd

Array = jax.Array


class LqrProblem(NamedTuple):
    """Canonical affine-quadratic trajectory problem (see module docstring).

    Shapes: A (T,n,n), B (T,n,m), c (T,n), Q (T,n,n), R (T,m,m), N (T,n,m),
    q (T,n), r (T,m), Qf (n,n), qf (n,), x0 (n,).
    """
    A: Array
    B: Array
    c: Array
    Q: Array
    R: Array
    N: Array
    q: Array
    r: Array
    Qf: Array
    qf: Array
    x0: Array


class LqrGains(NamedTuple):
    """Affine feedback u_t = -(K_t x_t + k_t) and value function (P_t, p_t)."""
    K: Array  # (T, m, n)
    k: Array  # (T, m)
    P: Array  # (T+1, n, n)
    p: Array  # (T+1, n)


def riccati_backward(prob: LqrProblem) -> LqrGains:
    """Sequential Riccati recursion via ``lax.scan`` (reversed).

    With value function V_t(x) = x'P_t x + 2 p_t'x + const:
        H = R_t + B'P B            (m,m)
        G = N_t' + B'P A           (m,n)
        g = r_t + B'(P c + p)      (m,)
        K = H^{-1} G,  k = H^{-1} g
        P_t = Q_t + A'P A - G'K
        p_t = q_t + A'(P c + p) - G'k
    """

    def step(carry, inp):
        P, p = carry
        A, B, c, Q, R, N, q, r = inp
        PB = P @ B
        H = R + B.T @ PB
        G = N.T + B.T @ (P @ A)
        g = r + B.T @ (P @ c + p)
        # Solve H [K k] = [G g] in one factorization.
        Kk = solve_spd(H, jnp.concatenate([G, g[:, None]], axis=1))
        K, k = Kk[:, :-1], Kk[:, -1]
        P_new = Q + A.T @ (P @ A) - G.T @ K
        # Symmetrize for numerical hygiene.
        P_new = 0.5 * (P_new + P_new.T)
        p_new = q + A.T @ (P @ c + p) - G.T @ k
        return (P_new, p_new), (K, k, P, p)

    inps = (prob.A, prob.B, prob.c, prob.Q, prob.R, prob.N, prob.q, prob.r)
    (P0, p0), (K, k, P_tail, p_tail) = jax.lax.scan(
        step, (prob.Qf, prob.qf), inps, reverse=True)
    # scan(reverse=True) emits per-step outputs ordered by t; the output at t
    # is the incoming carry, i.e. V_{t+1}.  Full value arrays are therefore
    # [V_0] + [V_1 .. V_T].
    P = jnp.concatenate([P0[None], P_tail], axis=0)
    p = jnp.concatenate([p0[None], p_tail], axis=0)
    return LqrGains(K=K, k=k, P=P, p=p)


class RiccatiFactorization(NamedTuple):
    """Sweep-invariant Riccati data (depends only on A, B, Q, R, N, Qf).

    ADMM box penalties perturb ONLY the linear cost terms (q, r, qf) between
    sweeps — every quadratic penalty rho*S'S is constant — so the feedback
    gains K, the input Hessians H, the cross blocks G, and the value
    Hessians P can be factored once and each sweep re-solves just the
    affine recursion (:func:`riccati_linear`).  This turns the boxed-QP
    inner loop from iters x full-Riccati into 1 x full + iters x linear.
    """
    K: Array   # (T, m, n)
    H: Array   # (T, m, m)
    G: Array   # (T, m, n)
    P: Array   # (T+1, n, n)  (P[t] = value Hessian at time t)


def riccati_factorize(prob: LqrProblem) -> RiccatiFactorization:
    """Backward pass over the quadratic terms only (q/r/qf never read)."""

    def step(P, inp):
        A, B, Q, R, N = inp
        PB = P @ B
        H = R + B.T @ PB
        G = N.T + B.T @ (P @ A)
        K = solve_spd(H, G)
        P_new = Q + A.T @ (P @ A) - G.T @ K
        P_new = 0.5 * (P_new + P_new.T)
        return P_new, (K, H, G, P)

    inps = (prob.A, prob.B, prob.Q, prob.R, prob.N)
    P0, (K, H, G, P_tail) = jax.lax.scan(step, prob.Qf, inps, reverse=True)
    P = jnp.concatenate([P0[None], P_tail], axis=0)
    return RiccatiFactorization(K=K, H=H, G=G, P=P)


def riccati_linear(prob: LqrProblem,
                   fac: RiccatiFactorization) -> LqrGains:
    """Affine backward recursion under a fixed factorization.

    Exactly the (k, p) recursion of :func:`riccati_backward` with (K, H, G,
    P) taken from ``fac``; bit-equivalent when ``prob``'s quadratic terms
    match the ones ``fac`` was built from (tested)."""

    def step(p, inp):
        A, B, c, q, r, H, G, P1 = inp
        Pc_p = P1 @ c + p
        g = r + B.T @ Pc_p
        k = solve_spd(H, g)
        p_new = q + A.T @ Pc_p - G.T @ k
        return p_new, (k, p)

    inps = (prob.A, prob.B, prob.c, prob.q, prob.r,
            fac.H, fac.G, fac.P[1:])
    p0, (k, p_tail) = jax.lax.scan(step, prob.qf, inps, reverse=True)
    p = jnp.concatenate([p0[None], p_tail], axis=0)
    return LqrGains(K=fac.K, k=k, P=fac.P, p=p)


class _AssocElem(NamedTuple):
    """Parallel-LQR element per Särkkä & García-Fernández (2021): the
    conditional value function between two times, parameterized as
    V(x_i -> x_j) with (F, b, C, eta, J)."""
    F: Array
    b: Array
    C: Array
    eta: Array
    J: Array


def _assoc_combine(e1: _AssocElem, e2: _AssocElem) -> _AssocElem:
    """Associative combination rule (batched over leading dims).

    Vectors are lifted to (..., n, 1) columns so every product is a clean
    batched matmul.
    """
    n = e1.F.shape[-1]
    I = jnp.broadcast_to(jnp.eye(n, dtype=e1.F.dtype), e1.F.shape)
    M = jnp.linalg.solve(I + e1.C @ e2.J, I)      # (I + C1 J2)^{-1}
    Mt = jnp.linalg.solve(I + e2.J @ e1.C, I)     # (I + J2 C1)^{-1}
    F2M = e2.F @ M
    F1t = jnp.swapaxes(e1.F, -1, -2)
    b1 = e1.b[..., None]
    eta2 = e2.eta[..., None]
    F = F2M @ e1.F
    b = (F2M @ (b1 + e1.C @ eta2))[..., 0] + e2.b
    C = F2M @ e1.C @ jnp.swapaxes(e2.F, -1, -2) + e2.C
    eta = (F1t @ Mt @ (eta2 - e2.J @ b1))[..., 0] + e1.eta
    J = F1t @ Mt @ e2.J @ e1.F + e1.J
    return _AssocElem(F, b, C, eta, J)


def riccati_backward_assoc(prob: LqrProblem) -> LqrGains:
    """Associative-scan Riccati: O(log T) depth parallel-in-time backward pass.

    Strategy: eliminate per-stage cross terms and linear-u terms by the
    substitution u = v - R^{-1}(N'x + r), reducing each stage to the standard
    LQT form used by the parallel formulation; then build elements and combine
    with ``lax.associative_scan`` (reversed).  Gains are recovered from the
    value functions P_{t+1}, p_{t+1} exactly as in the sequential pass.
    """
    T, n, m = prob.B.shape

    # --- canonicalize: remove cross term N and linear term r --------------
    Rinv_N = jnp.linalg.solve(prob.R, jnp.swapaxes(prob.N, 1, 2))  # (T,m,n)
    Rinv_r = jnp.linalg.solve(prob.R, prob.r[..., None])[..., 0]   # (T,m)
    A_bar = prob.A - prob.B @ Rinv_N
    c_bar = prob.c - (prob.B @ Rinv_r[..., None])[..., 0]
    Q_bar = prob.Q - prob.N @ Rinv_N
    q_bar = prob.q - (prob.N @ Rinv_r[..., None])[..., 0]

    # --- per-stage elements ----------------------------------------------
    # Element t represents the map from V_{t+1} to V_t for stage cost
    # x'Q̄x + 2q̄'x + v'Rv and dynamics x' = Ābar x + B v + c̄bar.
    Binv_R_Bt = prob.B @ jnp.linalg.solve(prob.R, jnp.swapaxes(prob.B, 1, 2))
    elems = _AssocElem(
        F=A_bar,
        b=c_bar,
        C=Binv_R_Bt,
        eta=-q_bar,
        J=Q_bar,
    )
    # Final element: identity map with terminal cost.
    final = _AssocElem(
        F=jnp.zeros((1, n, n), prob.A.dtype),
        b=jnp.zeros((1, n), prob.A.dtype),
        C=jnp.zeros((1, n, n), prob.A.dtype),
        eta=-prob.qf[None],
        J=prob.Qf[None],
    )
    all_elems = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0),
                             elems, final)
    # associative_scan(reverse=True) flips, prefix-scans, flips back: the
    # combine receives (suffix-composite-of-later, earlier) — swap into our
    # (earlier, later) convention.
    combined = jax.lax.associative_scan(
        lambda a, b: _assoc_combine(b, a), all_elems, reverse=True)
    # combined[t] composes stages t..T: V_t(x) = x'J x - 2 eta'x + const.
    P = combined.J
    p = -combined.eta

    # --- recover gains from V_{t+1} --------------------------------------
    def gains(A, B, c, R, N, r, P1, p1):
        H = R + B.T @ (P1 @ B)
        G = N.T + B.T @ (P1 @ A)
        g = r + B.T @ (P1 @ c + p1)
        Kk = solve_spd(H, jnp.concatenate([G, g[:, None]], axis=1))
        return Kk[:, :-1], Kk[:, -1]

    K, k = jax.vmap(gains)(prob.A, prob.B, prob.c, prob.R, prob.N, prob.r,
                           P[1:], p[1:])
    return LqrGains(K=K, k=k, P=P, p=p)


def lqr_rollout_linear(prob: LqrProblem, gains: LqrGains):
    """Roll the *linear* model under the affine feedback — the QP optimum.

    Returns (x_trj (T+1,n), u_trj (T,m)).
    """

    def step(x, inp):
        A, B, c, K, k = inp
        u = -(K @ x + k)
        x_next = A @ x + B @ u + c
        return x_next, (x, u)

    _, (xs, us) = jax.lax.scan(
        step, prob.x0, (prob.A, prob.B, prob.c, gains.K, gains.k))
    x_last = prob.A[-1] @ xs[-1] + prob.B[-1] @ us[-1] + prob.c[-1]
    x_trj = jnp.concatenate([xs, x_last[None]], axis=0)
    return x_trj, us


def lqr_solve(prob: LqrProblem, parallel: bool = False):
    """Solve the unconstrained affine-quadratic problem exactly.

    ``parallel=True`` uses the associative-scan backward pass, else the
    sequential scan.  Returns (x_trj, u_trj, gains)."""
    gains = (riccati_backward_assoc(prob) if parallel
             else riccati_backward(prob))
    x_trj, u_trj = lqr_rollout_linear(prob, gains)
    return x_trj, u_trj, gains


# ---------------------------------------------------------------------------
# Problem builders
# ---------------------------------------------------------------------------

def build_tracking_problem(
        A: Array, B: Array, c: Array,
        Q: Array, Qd: Array, R: Array,
        x0: Array, xd_trj: Array) -> LqrProblem:
    """Standard tracking problem: cost (x-xd)'Q(x-xd) + u'Ru, final Qd.

    Mirrors the unconstrained semantics of ``solve_tvlqr``
    (``tv_lqr.py:127-133``) without the Δu mode.
    """
    T, n, m = B.shape
    dt = A.dtype
    return LqrProblem(
        A=A, B=B, c=c,
        Q=jnp.broadcast_to(Q, (T, n, n)),
        R=jnp.broadcast_to(R, (T, m, m)),
        N=jnp.zeros((T, n, m), dt),
        q=-(xd_trj[:-1] @ Q.T),
        r=jnp.zeros((T, m), dt),
        Qf=Qd,
        qf=-(Qd @ xd_trj[-1]),
        x0=x0,
    )


def build_delta_u_problem(
        A: Array, B: Array, c: Array,
        Q: Array, Qd: Array, R: Array,
        x0: Array, xd_trj: Array,
        indices_u_into_x: Array) -> LqrProblem:
    """Δu-cost problem via prev-input state augmentation.

    The reference's position-controlled mode (``tv_lqr.py:98-110``) penalizes
    R on du = u_t - u_{t-1} (du_0 = u_0 - x_0[indices_u]).  We augment the
    state z = [x; w] with w_t = u_{t-1} (w_0 = x_0[indices_u]); the cost
    becomes stage-quadratic with a cross term:
        (u - w)'R(u - w) = u'Ru - 2 w'Ru + w'Rw.
    Returns an augmented LqrProblem with dim n+m; use
    :func:`split_augmented` to recover x/u trajectories.
    """
    T, n, m = B.shape
    dt = A.dtype
    na = n + m
    Z = jnp.zeros

    # Augmented dynamics: x' = A x + B u + c ; w' = u.
    A_aug = Z((T, na, na), dt)
    A_aug = A_aug.at[:, :n, :n].set(A)
    B_aug = Z((T, na, m), dt)
    B_aug = B_aug.at[:, :n, :].set(B)
    B_aug = B_aug.at[:, n:, :].set(jnp.broadcast_to(jnp.eye(m, dtype=dt),
                                                    (T, m, m)))
    c_aug = Z((T, na), dt).at[:, :n].set(c)

    # Stage cost: x-tracking Q + w'Rw + u'Ru - 2 w'Ru.
    Q_aug = Z((T, na, na), dt)
    Q_aug = Q_aug.at[:, :n, :n].set(jnp.broadcast_to(Q, (T, n, n)))
    Q_aug = Q_aug.at[:, n:, n:].set(jnp.broadcast_to(R, (T, m, m)))
    N_aug = Z((T, na, m), dt).at[:, n:, :].set(
        jnp.broadcast_to(-R, (T, m, m)))
    q_aug = Z((T, na), dt).at[:, :n].set(-(xd_trj[:-1] @ Q.T))

    Qf_aug = Z((na, na), dt).at[:n, :n].set(Qd)
    qf_aug = Z((na,), dt).at[:n].set(-(Qd @ xd_trj[-1]))

    x0_aug = jnp.concatenate([x0, x0[indices_u_into_x]])

    return LqrProblem(
        A=A_aug, B=B_aug, c=c_aug,
        Q=Q_aug, R=jnp.broadcast_to(R, (T, m, m)), N=N_aug,
        q=q_aug, r=Z((T, m), dt),
        Qf=Qf_aug, qf=qf_aug, x0=x0_aug)


def build_prev_u_tracking_problem(
        A: Array, B: Array, c: Array,
        Q: Array, Qd: Array, R: Array,
        x0: Array, xd_trj: Array) -> LqrProblem:
    """Tracking problem (plain u'Ru cost) with a prev-input augmented state.

    Used when relative input bounds (u_t - u_{t-1} boxes) must be enforced
    inside the QP for a system WITHOUT the Δu-cost mode.  The reference
    intends this (``tv_lqr.py:121-124`` adds the box unconditionally) but its
    defining equality ``du_t == u_t - u_{t-1}`` only exists in the Δu branch
    (``tv_lqr.py:98-105``), so its non-Δu rel bounds constrain free slack
    variables — a documented reference quirk we fix by augmenting
    z = [x; w], w_t = u_{t-1}, and boxing u - w in the ADMM solver.  The
    t=0 stage has no predecessor input; callers widen that row's box
    (w_0 is set to 0 and carries no cost).
    """
    T, n, m = B.shape
    dt = A.dtype
    na = n + m
    Z = jnp.zeros

    A_aug = Z((T, na, na), dt).at[:, :n, :n].set(A)
    B_aug = Z((T, na, m), dt).at[:, :n, :].set(B)
    B_aug = B_aug.at[:, n:, :].set(jnp.broadcast_to(jnp.eye(m, dtype=dt),
                                                    (T, m, m)))
    c_aug = Z((T, na), dt).at[:, :n].set(c)

    Q_aug = Z((T, na, na), dt).at[:, :n, :n].set(
        jnp.broadcast_to(Q, (T, n, n)))
    q_aug = Z((T, na), dt).at[:, :n].set(-(xd_trj[:-1] @ Q.T))
    Qf_aug = Z((na, na), dt).at[:n, :n].set(Qd)
    qf_aug = Z((na,), dt).at[:n].set(-(Qd @ xd_trj[-1]))

    x0_aug = jnp.concatenate([x0, jnp.zeros((m,), dt)])

    return LqrProblem(
        A=A_aug, B=B_aug, c=c_aug,
        Q=Q_aug, R=jnp.broadcast_to(R, (T, m, m)),
        N=Z((T, na, m), dt),
        q=q_aug, r=Z((T, m), dt),
        Qf=Qf_aug, qf=qf_aug, x0=x0_aug)


def split_augmented(x_aug_trj: Array, n: int):
    """Recover the physical state trajectory from an augmented solution."""
    return x_aug_trj[:, :n]
