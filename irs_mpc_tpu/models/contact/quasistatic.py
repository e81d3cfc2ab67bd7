"""Differentiable quasistatic contact dynamics (Anitescu convex time-stepping).

The on-device replacement for the reference's external C++ contact engine
(``QuasistaticSimulatorCpp`` driven through
``/root/reference/irs_lqr/quasistatic_dynamics.py``): position-controlled
robots with stiffness Kp, quasi-dynamic unactuated objects, friction via the
Anitescu cone discretization (nd_per_contact = 2 in 2D, matching the
reference drivers, e.g. ``run_planar_hand.py:24``), one convex QP per step,
analytic sensitivities by implicit differentiation (the role of
``requires_grad`` / ``grad_from_active_constraints``).

Step QP over the configuration change dq:

    min_dq  1/2 dq_a' Kp dq_a + (Kp (q_a - u))' dq_a        [elastic energy]
          + 1/2 dq_u' (M_u / h^2) dq_u - tau_ext' dq_u       [quasi-dynamic]
    s.t.    (J_n +- mu J_t) dq >= -phi_c   for every contact c

    q_next = q + dq*.

Statics check: an unactuated dof in free space settles at dq = h^2 M^{-1} tau
per step (constant-velocity fall), and in contact the QP trades elastic vs
contact energy exactly like the reference's formulation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..base import System
from . import geometry as geom
from .qp import solve_qp

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class ModelInstance:
    """A named group of dofs — the analogue of a Drake model instance, which
    the reference keys its cost dicts and u-marshalling on
    (``quasistatic_dynamics.py:58-119``)."""
    name: str
    q_indices: Tuple[int, ...]
    actuated: bool
    # actuated: per-dof stiffness Kp; unactuated: per-dof mass/inertia.
    stiffness: Optional[Tuple[float, ...]] = None
    mass: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass(frozen=True)
class ContactPair:
    """Collision candidate between two bodies' shapes (static enumeration).

    ``link_a``/``link_b`` select the link for Arm2D bodies (else ignored).
    """
    body_a: int
    body_b: int
    shape_a: int = 0
    shape_b: int = 0
    mu: float = 0.5


@dataclasses.dataclass(frozen=True)
class QuasistaticModel:
    """Static description of a quasistatic system; step() is pure."""
    name: str
    h: float
    nq: int
    models: Tuple[ModelInstance, ...]
    bodies: Tuple[geom.BodyBase, ...]
    pairs: Tuple[ContactPair, ...]
    gravity: Tuple[float, float] = (0.0, -10.0)
    # Per-unactuated-translation-dof gravity application: dict from model
    # name to (2,) direction selection is implicit: translation dofs get
    # m*g on the z component; rotation dofs get 0.
    qp_iters: int = 30
    # Warm-started solve budget for serial rollout chains (step_ws): each
    # knot starts from the previous knot's (dq, lam).  Empirically 10 warm
    # iterations match (or beat) 30 cold ones on every bundled system,
    # including the Kp=5e4 box-pivoting (warm-10 error 8e-4 vs cold-30's
    # 2e-2 against a converged solve).  Set to 0 to disable warm rollouts.
    qp_iters_ws: int = 10
    # Contact time-stepping scheme (the two models contrasted by the
    # reference's motivating study, examples/box_pushing/analysis/
    # box_on_box.py:11-34):
    #   "anitescu" — convex relaxation: every detected pair contributes cone
    #     rows G dq >= -phi, so a *positive* gap still resists a step that
    #     would close it (force ramps up through the gap — the boundary
    #     layer the study plots as a ramp).
    #   "lcp" — exact velocity-level complementarity, one-sided: only
    #     touching/penetrating pairs (phi <= 0) are active, with rows
    #     G dq >= 0.  Complementarity + stationarity + feasibility of that
    #     system ARE the KKT conditions of the same QP with masked rows and
    #     zeroed rhs, so it reuses the PDIP solver with static shapes.  The
    #     study's step-function: no force at any positive gap, full reaction
    #     once in contact.
    contact_model: str = "anitescu"
    # OPT-IN: canonicalize the warm-start dual carry of serial rollout
    # chains: the two cone rows of a contact share a near-degenerate
    # direction (the intra-pair split; measured: identical warm solves
    # agree on dq to 7e-5 while lam differs 87%), along which float-order
    # dust grows knot-to-knot.  Replacing each pair (lam1, lam2) by its
    # mean preserves the contact's total (normal-force) memory while
    # zeroing the free direction, which steadies STIFF warm chains.
    # Default OFF: the projection also resets the friction-force
    # component mu*(lam1-lam2) each knot, and friction-memory tasks
    # measurably lose their basins with it (planar_hand_spin first_order
    # 54.1 -> 127.9).  Enable per model where measured beneficial.
    canon_warm_duals: bool = False

    def __post_init__(self):
        if self.contact_model not in ("anitescu", "lcp"):
            raise ValueError(
                f"contact_model {self.contact_model!r} not in "
                f"('anitescu', 'lcp')")

    # ---- bookkeeping (mirrors QuasistaticDynamics marshalling) ----------

    @property
    def dim_x(self) -> int:
        return self.nq

    @property
    def dim_u(self) -> int:
        return sum(len(m.q_indices) for m in self.models if m.actuated)

    @property
    def models_actuated(self):
        return [m for m in self.models if m.actuated]

    @property
    def models_unactuated(self):
        return [m for m in self.models if not m.actuated]

    def indices_u_into_x(self) -> np.ndarray:
        """Reference ``get_u_indices_into_x`` (quasistatic_dynamics.py:58-66)."""
        out = []
        for m in self.models_actuated:
            out.extend(m.q_indices)
        return np.asarray(out, np.int32)

    def get_q_dict_from_x(self, x) -> Dict[str, Array]:
        return {m.name: x[..., list(m.q_indices)] for m in self.models}

    def get_x_from_q_dict(self, q_dict: Dict[str, np.ndarray]) -> np.ndarray:
        x = np.zeros(self.nq, np.float32)
        for m in self.models:
            x[list(m.q_indices)] = np.asarray(q_dict[m.name])
        return x

    def get_u_from_q_cmd_dict(self, q_cmd: Dict[str, np.ndarray]) -> np.ndarray:
        out = []
        for m in self.models_actuated:
            out.append(np.asarray(q_cmd[m.name]))
        return np.concatenate(out).astype(np.float32)

    def get_Q_from_Q_dict(self, Q_dict: Dict[str, np.ndarray]) -> np.ndarray:
        """Diagonal state cost from per-model weights
        (quasistatic_dynamics.py:103-110)."""
        Q = np.zeros((self.nq, self.nq), np.float32)
        for m in self.models:
            idx = np.asarray(m.q_indices)
            Q[idx, idx] = np.asarray(Q_dict[m.name])
        return Q

    def get_R_from_R_dict(self, R_dict: Dict[str, np.ndarray]) -> np.ndarray:
        vals = []
        for m in self.models_actuated:
            vals.append(np.asarray(R_dict[m.name]))
        v = np.concatenate(vals).astype(np.float32)
        return np.diag(v)

    # ---- QP assembly ----------------------------------------------------

    def _hessian_and_bias(self, q: Array, u: Array):
        """P (nq,nq) diagonal, b (nq,) of the step QP objective."""
        P_diag = jnp.zeros(self.nq, jnp.float32)
        b = jnp.zeros(self.nq, jnp.float32)
        iu = 0
        gz = jnp.asarray(self.gravity, jnp.float32)
        for m in self.models:
            idx = jnp.asarray(m.q_indices)
            if m.actuated:
                kp = jnp.asarray(m.stiffness, jnp.float32)
                P_diag = P_diag.at[idx].set(kp)
                nu = len(m.q_indices)
                b = b.at[idx].set(kp * (q[idx] - u[iu:iu + nu]))
                iu += nu
            else:
                mass = jnp.asarray(m.mass, jnp.float32)
                P_diag = P_diag.at[idx].set(mass / self.h ** 2)
                # Gravity on translation dofs: convention — for a FreeBody2D
                # the first two dofs are (y, z); rotation dof gets none.
                tau = jnp.zeros(len(m.q_indices))
                if len(m.q_indices) >= 2:
                    tau = tau.at[0].set(mass[0] * gz[0])
                    tau = tau.at[1].set(mass[1] * gz[1])
                b = b.at[idx].add(-tau * 1.0)
        return jnp.diag(P_diag), b

    def _body_point_jacobian(self, body_idx: int, q: Array, p: Array,
                             shape_idx: int):
        body = self.bodies[body_idx]
        if isinstance(body, geom.Arm2D):
            # shape k of an Arm2D is its k-th link capsule.
            return body.point_jacobian_link(q, p, shape_idx)
        return body.point_jacobian(q, p)

    def contact_rows(self, q: Array):
        """Assemble all contact constraint rows.

        Returns (G, phi): G (n_rows, nq), phi (n_rows,) such that the
        constraint set is G dq >= -phi (two Anitescu rows per contact point).
        """
        Gs, phis = [], []
        for pair in self.pairs:
            sa = self.bodies[pair.body_a].world_shapes(q)[pair.shape_a]
            sb = self.bodies[pair.body_b].world_shapes(q)[pair.shape_b]
            contacts = geom.shape_contact(sa, sb)
            for (phi, p, n) in contacts:
                Ja = self._body_point_jacobian(pair.body_a, q, p,
                                               pair.shape_a)
                Jb = self._body_point_jacobian(pair.body_b, q, p,
                                               pair.shape_b)
                Jrel = Jb - Ja                      # (2, nq)
                t = geom._perp(n)
                Jn = n @ Jrel                       # (nq,)
                Jt = t @ Jrel
                Gs.append(Jn + pair.mu * Jt)
                Gs.append(Jn - pair.mu * Jt)
                phis.append(phi)
                phis.append(phi)
        if not Gs:
            return None, None
        return jnp.stack(Gs), jnp.stack(phis)

    # ---- the step -------------------------------------------------------

    def _constraint_rows(self, q: Array):
        """Contact rows in the solver's C dq <= d form, per contact_model."""
        G, phi = self.contact_rows(q)
        if G is None:
            return None, None
        if self.contact_model == "lcp":
            # One-sided scheme: separated pairs (phi > 0) are vacuous rows
            # (0' dq <= 1, slack stays ~1 so the PDIP dual vanishes);
            # touching/penetrating pairs block relative motion at the
            # velocity level (G dq >= 0 — no pushout term, matching the
            # study's constant-reaction branch for phi < 0).
            active = (phi <= 0.0)[:, None]
            C = jnp.where(active, -G, 0.0)
            d = jnp.where(phi <= 0.0, 0.0, 1.0)
            return C, d
        # Anitescu: -G dq <= phi for every detected pair.
        return -G, phi

    def step(self, x: Array, u: Array) -> Array:
        """One quasistatic step: q_next = q + argmin QP.  Differentiable."""
        q = x
        P, b = self._hessian_and_bias(q, u)
        C, d = self._constraint_rows(q)
        if C is None:
            dq = -jnp.linalg.solve(P + 1e-9 * jnp.eye(self.nq), b)
        else:
            dq = solve_qp(P, b, C, d, self.qp_iters)
        return q + dq

    def n_constraint_rows(self) -> int:
        """Static number of contact rows (fixed by the geometry/pair list)."""
        G, _ = self.contact_rows(jnp.zeros(self.nq))
        return 0 if G is None else G.shape[0]

    def ws_init(self):
        """Initial warm-start carry for a rollout chain: (dq, lam) mirroring
        the cold start's lam0 = 1."""
        return (jnp.zeros(self.nq, jnp.float32),
                jnp.ones(self.n_constraint_rows(), jnp.float32))

    def canon_duals(self, lam: Array) -> Array:
        """Project a dual vector onto its canonical cone-pair split (see
        ``canon_warm_duals``): rows 2c/2c+1 of contact c are replaced by
        their mean.  Shape-preserving over any leading batch axes."""
        shp = lam.shape
        lp = lam.reshape(shp[:-1] + (shp[-1] // 2, 2))
        mean = jnp.mean(lp, axis=-1, keepdims=True)
        return jnp.broadcast_to(mean, lp.shape).reshape(shp)

    def step_ws(self, x: Array, u: Array, carry):
        """Warm-started step for serial rollouts: the PDIP starts from the
        previous knot's (dq, lam) and runs ``qp_iters_ws`` iterations (the
        reference's hot loop re-solves every knot cold through Gurobi,
        quasistatic_dynamics.py:242-266).  NOT differentiable — Jacobians
        and per-knot sampling always go through ``step``."""
        from .qp import solve_qp_warm
        q = x
        P, b = self._hessian_and_bias(q, u)
        C, d = self._constraint_rows(q)
        if C is None:
            dq = -jnp.linalg.solve(P + 1e-9 * jnp.eye(self.nq), b)
            return q + dq, carry
        dq, (dq_c, lam_c) = solve_qp_warm(P, b, C, d, carry,
                                          self.qp_iters_ws)
        if self.canon_warm_duals:
            lam_c = self.canon_duals(lam_c)
        return q + dq, (dq_c, lam_c)

    def system(self) -> System:
        """Wrap as the framework's System (step/vmap/jacfwd derived)."""
        use_ws = self.qp_iters_ws > 0 and bool(self.pairs)
        return System(name=self.name, dim_x=self.nq, dim_u=self.dim_u,
                      h=self.h, step=self.step,
                      step_ws_fn=self.step_ws if use_ws else None,
                      ws_init_fn=self.ws_init if use_ws else None)

    def _est_sweep_fn(self, qp_iters_samples: int):
        """Fused estimation sweep (System.est_sweep_fn contract): nominal
        steps at FULL accuracy (``self.qp_iters``) + all sample steps at
        the surrogate budget, one batched pass.

        Two structural wins over the per-knot path it replaces:
        * the nominal is solved ONCE (previously: an XLA f0 solve + the
          exact-Jacobian's forward + decouple_AB's true-system re-step all
          re-solved it, ~2/3 of the estimation wall);
        * ``dx=None`` (zero_order_B: samples share the nominal state) means
          the contact narrow phase runs once per KNOT, not once per sample
          — P is constant, C/d depend only on q, only the bias b varies.

        NOTE (measured negative result, r5): warm-starting the sample QPs
        from the nominal's (dq, lam) — the obvious-looking lever — makes
        accuracy WORSE at matched iteration counts (warm-8 max rel err
        0.79 vs cold-8's 3.5e-3 on contact-engaged planar-hand knots at
        std_u=0.3): the samples' active sets differ too much from the
        nominal's, and the inherited near-boundary (s, lam) collapses the
        fraction-to-boundary step.  Samples therefore solve COLD at
        ``qp_iters_samples`` (cold-15 is < 5e-8 from converged on the same
        distribution); warm starts stay where they are proven — serial
        rollout chains with small knot-to-knot drift.
        """
        import jax as _jax

        def est_sweep(x_nom, u_nom, dx, du):
            T, S, m = du.shape
            nq = self.nq
            # Nominal batch at full accuracy.
            Pn, bn = _jax.vmap(self._hessian_and_bias)(x_nom, u_nom)
            Cn, dn = _jax.vmap(self._constraint_rows)(x_nom)
            dq0 = _jax.vmap(
                lambda P, b, C, d: solve_qp(P, b, C, d, self.qp_iters)
            )(Pn, bn, Cn, dn)
            f_nom = x_nom + dq0

            if dx is None:
                xp = jnp.broadcast_to(x_nom[:, None], (T, S, nq))
                Cb = jnp.broadcast_to(Cn[:, None], (T, S) + Cn.shape[1:])
                db = jnp.broadcast_to(dn[:, None], (T, S) + dn.shape[1:])
            else:
                xp = x_nom[:, None] + dx
                Cb, db = _jax.vmap(_jax.vmap(self._constraint_rows))(xp)
            up = u_nom[:, None] + du
            Pb, bb = _jax.vmap(_jax.vmap(self._hessian_and_bias))(xp, up)

            flat = lambda a: a.reshape((T * S,) + a.shape[2:])
            dq = _jax.vmap(
                lambda P, b, C, d: solve_qp(P, b, C, d, qp_iters_samples)
            )(flat(Pb), flat(bb), flat(Cb), flat(db))
            fd = xp + dq.reshape(T, S, nq)
            return f_nom, fd

        return est_sweep

    def estimation_surrogate(self, qp_iters: int = 15) -> System:
        """Cheaper system for the Monte-Carlo estimation sweep: reduced QP
        iterations and the fused sweep hook (one nominal solve at full
        accuracy + shared-constraint sample assembly).  Pass as
        ``IrsMpcParams.estimation_system``."""
        import dataclasses as _dc

        cheap = _dc.replace(self, qp_iters=qp_iters)
        sys = cheap.system()
        if not self.pairs:
            return sys
        return _dc.replace(sys, est_sweep_fn=self._est_sweep_fn(qp_iters))
