"""iRS-MPC driver: iterative randomized-smoothing LQR, one jitted step/iter.

Re-expresses the reference's solver family —
``IrsLqr``/``IrsLqrExact``/``IrsLqrFirstOrder``/``IrsLqrZeroOrder``
(``/root/reference/irs_lqr/irs_lqr*.py``) and the quasistatic/MBP variants
(``irs_lqr_quasistatic.py``, ``irs_lqr_mbp*.py``) — as a single driver whose
per-iteration work is ONE compiled XLA program:

    sample -> rollout -> moment-reduce -> fit (A,B,c) -> Riccati -> forward.

Key semantic note on the forward pass: the reference re-solves the QP over the
shrinking horizon [t, T] at every t and keeps only u*[0]
(``irs_lqr.py:148-186``) — O(T^2) QP solves.  For the *unconstrained* problem
this is mathematically identical to ONE full-horizon Riccati backward pass
followed by an affine-feedback rollout of the true dynamics (Bellman: the tail
problem from t is independent of the past), which is what ``feedback`` mode
does in O(T).  With box bounds, ``feedback`` clips inputs during the rollout
(projected feedback); the exact constrained per-knot resolve is available via
the boxed-QP backend (ops/admm.py) in ``resolve`` mode.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import System
from ..ops import admm as admm_ops
from ..ops import lqr as lqr_ops
from ..ops.estimators import (SmoothingConfig, TvLinearization, decouple_AB,
                              estimate_tv_matrices_fnom)

Array = jax.Array

# "Infinite" box bound used to mask padded/unconstrained stages.  Must be
# (a) far above any user bound magnitude so clip() is a no-op there, and
# (b) small enough that its square (ADMM penalty terms ~ rho * BIG^2) stays
# comfortably inside float32 range.  1e7 gives BIG^2 = 1e14 << 3.4e38 while
# supporting bounds up to 1e6 — construction validates user bounds against
# BOUND_BIG / 10 so nothing can silently saturate.
BOUND_BIG = 1e7


@dataclasses.dataclass
class IrsMpcParams:
    """Optimal-control problem + algorithm configuration.

    Mirrors ``IrsLqrParameters`` (``irs_lqr.py:7-31``) and
    ``IrsLqrQuasistaticParameters`` (``irs_lqr_quasistatic.py:12-41``).
    Bounds are (2, dim) arrays [lb; ub]; ``None`` disables them.
    """
    Q: np.ndarray | Array = None
    Qd: np.ndarray | Array = None
    R: np.ndarray | Array = None
    x0: np.ndarray | Array = None
    xd_trj: np.ndarray | Array = None
    u_trj_init: np.ndarray | Array = None

    # Bounds (reference: 4 kinds, irs_lqr_quasistatic.py:23-28).
    x_bounds_abs: Optional[np.ndarray] = None
    u_bounds_abs: Optional[np.ndarray] = None
    x_bounds_rel: Optional[np.ndarray] = None
    u_bounds_rel: Optional[np.ndarray] = None
    # Quasistatic solvers recentre abs bounds on the nominal trajectory each
    # iteration — a trust region (irs_lqr_quasistatic.py:302-323).
    bounds_trust_region: bool = False

    # Position-controlled (Δu-cost) mode: indices of actuated DOFs in x
    # (tv_lqr.py:98-110).  None => plain u'Ru cost.
    indices_u_into_x: Optional[np.ndarray] = None
    # Indices of unactuated DOFs in x, for the Qu/Qa cost-channel split
    # (irs_lqr_quasistatic.py:156-193).  None => all cost reported as Qa.
    unactuated_indices: Optional[np.ndarray] = None

    # Smoothing / estimation.
    gradient_mode: str = "zero_order"
    smoothing: SmoothingConfig = dataclasses.field(default_factory=SmoothingConfig)
    decouple_AB: bool = False
    # Optional cheaper surrogate dynamics used ONLY for the Monte-Carlo
    # estimation sweep (e.g. a contact model with fewer QP iterations) —
    # rollouts and cost evaluation always use the true system.  The sample
    # targets are noisy by construction, so a looser solve loses nothing.
    estimation_system: Optional[System] = None

    # Solve configuration.
    forward_mode: str = "feedback"       # "feedback" | "resolve"
    # Forward-pass line search step sizes (alpha=0 keeps the nominal
    # trajectory, so the accepted iterate never regresses).
    line_search_alphas: tuple = (1.0, 0.6, 0.3, 0.1, 0.03, 0.0)
    parallel_riccati: bool = False       # associative-scan backward pass
    admm_iters: int = 60                 # boxed-QP iterations (resolve mode)
    admm_rho: float = 1.0
    admm_over_relax: float = 1.0         # 1.6 ~halves admm_iters (Boyd §3.4.3)
    # Boxed-QP implementation: None = the whole-loop GPU kernel wherever
    # ops/admm.kernel_unsupported allows it, XLA loops elsewhere; True
    # demands the kernel (raises where it cannot run); False forces XLA.
    admm_kernel: Optional[bool] = None
    seed: int = 0
    # Optional jax.sharding.Mesh with ("sample", "knot") axes: shards the
    # Monte-Carlo estimation across devices (replaces the reference's ZMQ
    # worker farm, see parallel/sharded.py).
    mesh: Optional[object] = None
    # The reference's evaluate_cost uses Q (not Qd) on the final state — a
    # quirk (irs_lqr.py:134-136).  Keep True to match its CSV baselines.
    report_final_cost_with_Q: bool = True
    # Called after every accepted iteration with (iteration, x_trj, u_trj) —
    # the analogue of publish_every_iteration's meshcat streaming
    # (irs_lqr_quasistatic.py:368-369); use for live viz or checkpointing.
    iteration_callback: Optional[Callable] = None


@dataclasses.dataclass
class IterationStats:
    """Decomposed cost channels, mirroring the reference's
    {Qu, Qu_final, Qa, Qa_final, R} tracking
    (irs_lqr_quasistatic.py:100-109).  For systems without an
    actuated/unactuated split, the Qa channels carry the full state cost."""
    cost: float
    cost_Qu: float
    cost_Qu_final: float
    cost_Qa: float
    cost_Qa_final: float
    cost_R: float
    wall_time: float


class IrsMpc:
    """Public solver API, mirroring the reference's uniform surface:
    construct with (system, params), then ``iterate(n) -> (x_trj, u_trj,
    cost)``, with history in ``x_trj_lst``/``u_trj_lst``/``cost_lst`` and
    best-so-far tracking (``irs_lqr_quasistatic.py:91-109``)."""

    def __init__(self, system: System, params: IrsMpcParams):
        self.system = system
        self.params = params
        self._validate()

        p = params
        f32 = lambda a: None if a is None else jnp.asarray(a, jnp.float32)
        self.Q, self.Qd, self.R = f32(p.Q), f32(p.Qd), f32(p.R)
        self.x0 = f32(p.x0)
        self.xd_trj = f32(p.xd_trj)
        self.u_trj = f32(p.u_trj_init)
        self.T = int(self.u_trj.shape[0])
        self.idx_u = (None if p.indices_u_into_x is None
                      else jnp.asarray(p.indices_u_into_x, jnp.int32))
        # The QP state is augmented with a prev-input block w_t = u_{t-1}
        # whenever the Δu cost needs it OR relative input bounds must be
        # enforced in plain-u mode (the reference's tv_lqr.py:121-124 intends
        # the latter but its du equality only exists in the Δu branch,
        # tv_lqr.py:98-105 — a quirk we fix; see build_prev_u_tracking_problem).
        self._aug = (self.idx_u is not None) or (p.u_bounds_rel is not None)

        self.key = jax.random.PRNGKey(p.seed)
        # Same matmul precision as the jitted iteration (_iteration wraps
        # everything in "highest"), so the alpha=0 line-search branch's
        # re-roll of this nominal is bitwise-consistent with it — contact
        # systems can amplify bf16-vs-f32 differences into divergent
        # trajectories.
        with jax.default_matmul_precision("highest"):
            self.x_trj = system.rollout(self.x0, self.u_trj)
            self.cost = float(self.eval_cost(self.x_trj, self.u_trj)[0])

        self.x_trj_lst = [np.asarray(self.x_trj)]
        self.u_trj_lst = [np.asarray(self.u_trj)]
        self.cost_lst = [self.cost]
        self.stats_lst: list[IterationStats] = []
        self.x_trj_best = np.asarray(self.x_trj)
        self.u_trj_best = np.asarray(self.u_trj)
        self.cost_best = self.cost
        self.iter = 1
        self.start_time = time.time()

        self._iteration_jit = jax.jit(self._iteration)

    # ------------------------------------------------------------------
    def _validate(self):
        """Reference check_valid_system/check_valid_params
        (irs_lqr.py:73-103), including the probe evaluation of dynamics."""
        s, p = self.system, self.params
        if s.dim_x == 0 or s.dim_u == 0:
            raise RuntimeError("System has zero states or inputs.")
        if np.shape(p.Q) != (s.dim_x, s.dim_x):
            raise RuntimeError("Q must be dim_x x dim_x.")
        if np.shape(p.Qd) != (s.dim_x, s.dim_x):
            raise RuntimeError("Qd must be dim_x x dim_x.")
        if np.shape(p.R) != (s.dim_u, s.dim_u):
            raise RuntimeError("R must be dim_u x dim_u.")
        try:
            out = s.step(jnp.zeros(s.dim_x), jnp.zeros(s.dim_u))
            if out.shape != (s.dim_x,):
                raise ValueError(f"step returned shape {out.shape}")
        except Exception as e:
            raise RuntimeError(
                "Could not evaluate dynamics. Have you implemented it?"
            ) from e
        # Finite bound magnitudes must stay well below the BOUND_BIG mask
        # used for padded/unconstrained stages, or those stages would clip
        # real values (silent corruption in resolve-mode padding).
        for name in ("x_bounds_abs", "u_bounds_abs",
                     "x_bounds_rel", "u_bounds_rel"):
            b = getattr(p, name)
            if b is None:
                continue
            mags = np.abs(np.asarray(b, np.float64))
            mags = mags[np.isfinite(mags)]
            if mags.size and mags.max() > BOUND_BIG / 10:
                raise RuntimeError(
                    f"{name} magnitude {mags.max():.3g} exceeds the "
                    f"representable limit {BOUND_BIG / 10:.3g}; use "
                    f"np.inf (or None) for unconstrained entries.")

    # ------------------------------------------------------------------
    def eval_cost(self, x_trj: Array, u_trj: Array):
        """Returns (total, cost_Qu, cost_Qu_final, cost_Qa, cost_Qa_final,
        cost_R) — the reference's five channels (irs_lqr_quasistatic.py:
        156-193).  The Qu/Qa split follows ``unactuated_indices`` (empty =>
        everything lands in Qa, the generic-solver behavior).

        Running state cost uses Q; final uses Q under
        ``report_final_cost_with_Q`` (generic-path quirk, irs_lqr.py:134-136)
        else Qd (quasistatic path).  In Δu mode the R-cost is du'R du with
        du_0 = u_0 - x_0[idx] (irs_lqr_quasistatic.py:185-191)."""
        n = self.system.dim_x
        mask_u = jnp.zeros((n,), jnp.float32)
        if self.params.unactuated_indices is not None:
            mask_u = mask_u.at[
                jnp.asarray(self.params.unactuated_indices)].set(1.0)
        mask_a = 1.0 - mask_u

        ex = x_trj[:-1] - self.xd_trj[:-1]
        Qf = self.Q if self.params.report_final_cost_with_Q else self.Qd
        ef = x_trj[-1] - self.xd_trj[-1]

        def total_cost(e, M):
            return jnp.einsum("...i,ij,...j->", e, M, e)

        def u_channel(e, M):
            return jnp.einsum("...i,ij,...j->", e * mask_u, M, e * mask_u)

        # Channels defined so they always sum to the true total even for
        # non-diagonal Q (cross-block terms land in the Qa channel).
        cx, cxf = total_cost(ex, self.Q), total_cost(ef, Qf)
        cost_Qu = u_channel(ex, self.Q)
        cost_Quf = u_channel(ef, Qf)
        cost_Qa = cx - cost_Qu
        cost_Qaf = cxf - cost_Quf

        if self.idx_u is None:
            cost_R = jnp.einsum("ti,ij,tj->", u_trj, self.R, u_trj)
        else:
            u_prev = jnp.concatenate(
                [x_trj[0, self.idx_u][None], u_trj[:-1]], axis=0)
            du = u_trj - u_prev
            cost_R = jnp.einsum("ti,ij,tj->", du, self.R, du)
        total = cost_Qu + cost_Qa + cost_Quf + cost_Qaf + cost_R
        return total, cost_Qu, cost_Quf, cost_Qa, cost_Qaf, cost_R

    # ------------------------------------------------------------------
    def _build_problem(self, tv: TvLinearization, x_trj):
        p = self.params
        if self.idx_u is not None:
            return lqr_ops.build_delta_u_problem(
                tv.A, tv.B, tv.c, self.Q, self.Qd, self.R,
                x_trj[0], self.xd_trj, self.idx_u)
        if self._aug:
            # Plain u'Ru cost, but rel input bounds need the prev-u block.
            return lqr_ops.build_prev_u_tracking_problem(
                tv.A, tv.B, tv.c, self.Q, self.Qd, self.R,
                x_trj[0], self.xd_trj)
        return lqr_ops.build_tracking_problem(
            tv.A, tv.B, tv.c, self.Q, self.Qd, self.R,
            x_trj[0], self.xd_trj)

    def _u_bounds_for_rollout(self, x_trj):
        """Per-knot (lb, ub) input bounds for the projected-feedback rollout,
        combining abs (possibly trust-region-recentred,
        irs_lqr_quasistatic.py:302-323) and rel bounds."""
        p = self.params
        T, m = self.T, self.system.dim_u
        lb = jnp.full((T, m), -jnp.inf)
        ub = jnp.full((T, m), jnp.inf)
        if p.u_bounds_abs is not None:
            b = jnp.asarray(p.u_bounds_abs, jnp.float32)
            if p.bounds_trust_region:
                centre = x_trj[:-1, self.idx_u] if self.idx_u is not None \
                    else jnp.zeros((T, m))
                lb = jnp.maximum(lb, centre + b[0])
                ub = jnp.minimum(ub, centre + b[1])
            else:
                lb = jnp.maximum(lb, b[0][None])
                ub = jnp.minimum(ub, b[1][None])
        return lb, ub

    def _iteration(self, x_trj, u_trj, key, it):
        """One smoothing + descent iteration (fully jitted).

        Wrapped in ``default_matmul_precision('highest')``: the Riccati and
        least-squares matrices are tiny but ill-conditioned, and a GPU's
        default float32 matmul may run in TF32 (about three decimal digits),
        which degrades convergence (observed with reduced-precision matmuls:
        pendulum 349.5 -> 420.9).  The Monte-Carlo rollout bulk is
        elementwise work, so full-precision matmuls cost ~nothing.
        """
        with jax.default_matmul_precision("highest"):
            return self._iteration_impl(x_trj, u_trj, key, it)

    def _has_bounds(self):
        p = self.params
        return any(b is not None for b in (p.x_bounds_abs, p.u_bounds_abs,
                                           p.x_bounds_rel, p.u_bounds_rel))

    def _box_bounds(self, x_trj):
        """Assemble per-knot BoxBounds, with the quasistatic solvers'
        trust-region recentring on the nominal trajectory
        (irs_lqr_quasistatic.py:302-323) when enabled."""
        p = self.params
        T, n, m = self.T, self.system.dim_x, self.system.dim_u
        f32 = jnp.float32

        def bx():
            if p.x_bounds_abs is None:
                return None
            b = jnp.asarray(p.x_bounds_abs, f32)
            if p.bounds_trust_region:
                return jnp.stack([x_trj + b[0], x_trj + b[1]])
            return jnp.stack([jnp.broadcast_to(b[0], (T + 1, n)),
                              jnp.broadcast_to(b[1], (T + 1, n))])

        def bu():
            if p.u_bounds_abs is None:
                return None
            b = jnp.asarray(p.u_bounds_abs, f32)
            if p.bounds_trust_region and self.idx_u is not None:
                centre = x_trj[:-1, self.idx_u]
                return jnp.stack([centre + b[0], centre + b[1]])
            return jnp.stack([jnp.broadcast_to(b[0], (T, m)),
                              jnp.broadcast_to(b[1], (T, m))])

        def brel(b_arr, dim):
            if b_arr is None:
                return None
            b = jnp.asarray(b_arr, f32)
            return jnp.stack([jnp.broadcast_to(b[0], (T, dim)),
                              jnp.broadcast_to(b[1], (T, dim))])

        du = brel(p.u_bounds_rel, m)
        if du is not None and self.idx_u is None:
            # Plain-u mode: no predecessor input exists at t=0 (the Δu mode
            # anchors to x0[idx_u]); leave the first stage unconstrained.
            du = du.at[0, 0].set(-BOUND_BIG).at[1, 0].set(BOUND_BIG)

        return admm_ops.BoxBounds(
            x=bx(), u=bu(), dx=brel(p.x_bounds_rel, n), du=du)

    def _resolve_forward(self, prob, x_trj, u_trj):
        """Exact receding-horizon forward pass: at every knot t, re-solve the
        constrained QP over [t, T] from the actually-achieved state and keep
        only u*[t] — the reference's semantics (irs_lqr.py:169-184,
        irs_lqr_quasistatic.py:325-345), O(T) full-horizon ADMM solves.

        Subproblems are realized as masked full-horizon problems: stages
        s < t get identity dynamics (with the Δu prev-input block pinned to
        x[idx_u]), zero cost, and infinite boxes, which makes the tail
        [t, T] of the padded solve exactly the reference's shrunk-horizon
        QP."""
        p = self.params
        sys = self.system
        T, m = self.T, sys.dim_u
        n = sys.dim_x
        n_aug = prob.A.shape[1]
        f32 = jnp.float32
        eye_aug = jnp.eye(n_aug, dtype=f32)

        # Identity-padding stage dynamics: x'=x; w' = x[idx_u] (Δu mode) or
        # w'=w (plain-u with rel bounds: w carries u_prev unchanged through
        # padded stages, so the tail problem's first rel bound anchors to the
        # actually-applied previous input).
        A_pad = eye_aug
        if self.idx_u is not None:
            A_pad = A_pad.at[n:, :].set(0.0)
            A_pad = A_pad.at[jnp.arange(n, n_aug), self.idx_u].set(1.0)
        R_pad = jnp.eye(m, dtype=f32) * 1e-4

        bounds = self._box_bounds(x_trj)
        big = jnp.asarray(BOUND_BIG, f32)
        idx_w = (np.arange(n, n_aug) if self._aug else None)

        def mask_bounds(b, t, time_len):
            if b is None:
                return None
            keep = (jnp.arange(time_len) >= t)
            if time_len == T + 1:
                keep = keep.at[-1].set(True)
            lb = jnp.where(keep[:, None], b[0], -big)
            ub = jnp.where(keep[:, None], b[1], big)
            return jnp.stack([lb, ub])

        def knot(carry, t):
            x_cur, u_prev, ws = carry
            mask_t = (jnp.arange(T) >= t).astype(f32)[:, None, None]
            prob_t = prob._replace(
                A=mask_t * prob.A + (1 - mask_t) * A_pad,
                B=mask_t * prob.B,
                c=mask_t[..., 0] * prob.c,
                Q=mask_t * prob.Q,
                R=mask_t * prob.R + (1 - mask_t) * R_pad,
                N=mask_t * prob.N,
                q=mask_t[..., 0] * prob.q,
                r=mask_t[..., 0] * prob.r,
                x0=(jnp.concatenate([x_cur, x_cur[self.idx_u]])
                    if self.idx_u is not None else
                    jnp.concatenate([x_cur, u_prev]) if self._aug
                    else x_cur),
            )
            bounds_t = admm_ops.BoxBounds(
                x=mask_bounds(bounds.x, t, T + 1),
                u=mask_bounds(bounds.u, t, T),
                dx=mask_bounds(bounds.dx, t, T),
                du=mask_bounds(bounds.du, t, T))
            sol = admm_ops.solve_boxed_tvlqr(
                prob_t, bounds_t, n_phys=n, idx_w=idx_w,
                rho=p.admm_rho, iters=p.admm_iters,
                over_relax=p.admm_over_relax, kernel=p.admm_kernel)
            u = jnp.nan_to_num(sol.u_trj[t])
            if sys.step_ws_fn is not None:
                x_next, ws = sys.step_ws_fn(x_cur, u, ws)
            else:
                x_next = sys.step(x_cur, u)
            return (x_next, u, ws), (x_next, u)

        u_prev0 = (x_trj[0, self.idx_u] if self.idx_u is not None
                   else jnp.zeros((m,), f32))
        ws0 = sys.ws_init_fn() if sys.step_ws_fn is not None else ()
        _, (xs, us) = jax.lax.scan(knot, (x_trj[0], u_prev0, ws0),
                                   jnp.arange(T))
        x_new = jnp.concatenate([x_trj[0][None], xs], axis=0)
        return x_new, us

    def _iteration_impl(self, x_trj, u_trj, key, it):
        """sample -> estimate (A, B, c) -> trajectory QP -> line-searched
        true-dynamics rollout; each phase under its own named scope."""
        key, k_est = jax.random.split(key)
        with jax.named_scope("estimation"):
            tv = self._estimate(x_trj, u_trj, k_est, it)
        prob = self._build_problem(tv, x_trj)

        if self.params.forward_mode == "resolve":
            x_new, us = self._resolve_forward(prob, x_trj, u_trj)
            channels = self.eval_cost(x_new, us)
            # No line search in resolve mode (reference semantics); fall back
            # to the nominal only on numerical failure.
            bad = ~jnp.isfinite(channels[0])
            nominal = self.eval_cost(x_trj, u_trj)
            x_new = jnp.where(bad, x_trj, x_new)
            us = jnp.where(bad, u_trj, us)
            cvec = jnp.where(bad, jnp.stack(nominal), jnp.stack(channels))
            return x_new, us, key, cvec

        with jax.named_scope("trajectory_qp"):
            gains, z_plan, u_plan = self._plan(prob, x_trj)
        with jax.named_scope("forward_rollout"):
            x_new, us, cvec = self._line_search(x_trj, u_trj, gains, z_plan,
                                                u_plan)
        return x_new, us, key, cvec

    def _estimate(self, x_trj, u_trj, k_est, it) -> TvLinearization:
        """Smoothed time-varying linearization around the nominal."""
        p = self.params
        sys = self.system
        # The cheaper estimation surrogate is justified by Monte-Carlo noise
        # in the sample targets; "exact" mode has no sampling, so it always
        # linearizes the true system (reference: calc_AB_exact runs the full
        # C++ sim, quasistatic_dynamics.py:190-191).
        est_sys = (sys if p.gradient_mode == "exact"
                   else p.estimation_system or sys)
        if p.mesh is not None:
            from ..parallel.sharded import sharded_estimate_tv_matrices
            tv = sharded_estimate_tv_matrices(
                est_sys, p.gradient_mode, x_trj, u_trj, k_est, it,
                p.smoothing, p.mesh)
            f_nom_est = None
        else:
            # need_A=False: decouple_AB is about to overwrite A, so the
            # fused-hook path skips the exact-Jacobian A estimate entirely
            # (the most expensive node of the zero_order_B sweep).
            tv, f_nom_est = estimate_tv_matrices_fnom(
                est_sys, p.gradient_mode, x_trj, u_trj, k_est, it,
                p.smoothing, need_A=not p.decouple_AB)
        if p.decouple_AB:
            tv = decouple_AB(tv, self.idx_u, x_trj, u_trj, sys,
                             f_nom=f_nom_est)
        return tv

    def _plan(self, prob, x_trj):
        """Solve the trajectory QP: boxed ADMM when any bound is set, else
        one Riccati pass.  Returns sanitized (gains, z_plan, u_plan)."""
        p = self.params
        n, m = self.system.dim_x, self.system.dim_u
        if self._has_bounds():
            idx_w = (np.arange(n, n + m) if self._aug else None)
            sol = admm_ops.solve_boxed_tvlqr(
                prob, self._box_bounds(x_trj), n_phys=n, idx_w=idx_w,
                rho=p.admm_rho, iters=p.admm_iters,
                over_relax=p.admm_over_relax,
                parallel=p.parallel_riccati, kernel=p.admm_kernel)
            gains, z_plan, u_plan = sol.gains, sol.x_trj, sol.u_trj
        else:
            z_plan, u_plan, gains = lqr_ops.lqr_solve(
                prob, parallel=p.parallel_riccati)

        # Sanitize: if a degenerate estimate produced non-finite gains or
        # plans, zero them so the alpha=0 line-search branch still exactly
        # reproduces the nominal trajectory (NaN * 0 would otherwise
        # poison every branch).
        gains = gains._replace(K=jnp.nan_to_num(gains.K),
                               k=jnp.nan_to_num(gains.k))
        return gains, jnp.nan_to_num(z_plan), jnp.nan_to_num(u_plan)

    def _line_search(self, x_trj, u_trj, gains, z_plan, u_plan):
        """Forward pass: roll the TRUE nonlinear dynamics under affine
        feedback around the planned trajectory,
            u_t = u*_t - K_t (z_t - z*_t),
        clipped to the input bounds.  At full step this is exactly
        u = -(K z + k), which equals the reference's per-knot
        shrinking-horizon QP chain (Bellman).  A vmapped line search over
        step sizes alpha blends plan toward nominal — alpha=0 reproduces
        the nominal trajectory exactly, so the accepted cost never
        increases (the reference has no such safeguard and its exact mode
        can blow up outside the QP's feasible region).  Returns the
        accepted (x_new, u_new, cost channels)."""
        p = self.params
        sys = self.system
        m = sys.dim_u
        lb, ub = self._u_bounds_for_rollout(x_trj)
        has_rel = p.u_bounds_rel is not None
        if has_rel:
            # Per-knot rel boxes; in plain-u mode t=0 has no predecessor
            # input, so its row is unconstrained (matches _box_bounds).
            rel = jnp.asarray(p.u_bounds_rel, jnp.float32)
            rel_lb = jnp.broadcast_to(rel[0], (self.T, m))
            rel_ub = jnp.broadcast_to(rel[1], (self.T, m))
            if self.idx_u is None:
                rel_lb = rel_lb.at[0].set(-jnp.inf)
                rel_ub = rel_ub.at[0].set(jnp.inf)
        else:
            rel_lb = jnp.full((self.T, m), -jnp.inf)
            rel_ub = jnp.full((self.T, m), jnp.inf)
        u_prev0 = (x_trj[0, self.idx_u] if self.idx_u is not None
                   else jnp.zeros((m,), jnp.float32))
        if self._aug:
            w_nom = jnp.concatenate([u_prev0[None], u_trj[:-1]], axis=0)
            z_nom = jnp.concatenate([x_trj[:-1], w_nom], axis=1)
        else:
            z_nom = x_trj[:-1]

        def rollout(alpha):
            z_ref = z_nom + alpha * (z_plan[:-1] - z_nom)
            u_ref = u_trj + alpha * (u_plan - u_trj)

            def fwd_step(carry, inp):
                x, u_prev, ws = carry
                K, z_r, u_r, lb_t, ub_t, rlb_t, rub_t = inp
                z = (jnp.concatenate([x, u_prev]) if self._aug else x)
                u = u_r - K @ (z - z_r)
                if has_rel:
                    u = jnp.clip(u, u_prev + rlb_t, u_prev + rub_t)
                u = jnp.clip(u, lb_t, ub_t)
                if sys.step_ws_fn is not None:
                    x_next, ws = sys.step_ws_fn(x, u, ws)
                else:
                    x_next = sys.step(x, u)
                return (x_next, u, ws), (x_next, u)

            ws0 = sys.ws_init_fn() if sys.step_ws_fn is not None else ()
            _, (xs, us) = jax.lax.scan(
                fwd_step, (x_trj[0], u_prev0, ws0),
                (gains.K, z_ref, u_ref, lb, ub, rel_lb, rel_ub))
            x_new = jnp.concatenate([x_trj[0][None], xs], axis=0)
            channels = self.eval_cost(x_new, us)
            return x_new, us, jnp.stack(channels)

        alphas = jnp.asarray(p.line_search_alphas, jnp.float32)
        xs_all, us_all, costs_all = jax.vmap(rollout)(alphas)
        totals = jnp.where(jnp.isnan(costs_all[:, 0]), jnp.inf,
                           costs_all[:, 0])
        best = jnp.argmin(totals)
        return xs_all[best], us_all[best], costs_all[best]

    # ------------------------------------------------------------------
    def local_descent(self, x_trj, u_trj):
        x_new, u_new, self.key, _ = self._iteration_jit(
            x_trj, u_trj, self.key, jnp.asarray(self.iter, jnp.float32))
        return x_new, u_new

    def iterate(self, max_iterations: int, verbose: bool = True):
        """Run ``max_iterations`` descent iterations.

        NOTE: the reference loops ``max_iterations + 1`` times due to a
        post-append check (``irs_lqr.py:196-216``) — documented quirk we fix;
        this runs exactly ``max_iterations`` descents."""
        for _ in range(max_iterations):
            t0 = time.time()
            x_new, u_new, self.key, cvec = self._iteration_jit(
                self.x_trj, self.u_trj, self.key,
                jnp.asarray(self.iter, jnp.float32))
            total, c_qu, c_quf, c_qa, c_qaf, c_r = [float(v) for v in cvec]
            wall = time.time() - t0
            if verbose:
                print(f"Iteration: {self.iter:02d} || Current Cost: "
                      f"{total:.6f} || Elapsed time: "
                      f"{time.time() - self.start_time:.5f}")

            self.x_trj_lst.append(np.asarray(x_new))
            self.u_trj_lst.append(np.asarray(u_new))
            self.cost_lst.append(total)
            self.stats_lst.append(IterationStats(
                cost=total, cost_Qu=c_qu, cost_Qu_final=c_quf,
                cost_Qa=c_qa, cost_Qa_final=c_qaf, cost_R=c_r,
                wall_time=wall))

            if total < self.cost_best:
                self.cost_best = total
                self.x_trj_best = np.asarray(x_new)
                self.u_trj_best = np.asarray(u_new)

            if self.params.iteration_callback is not None:
                self.params.iteration_callback(self.iter, np.asarray(x_new),
                                               np.asarray(u_new))

            self.cost = total
            self.x_trj = x_new
            self.u_trj = u_new
            self.iter += 1

        return self.x_trj, self.u_trj, self.cost
