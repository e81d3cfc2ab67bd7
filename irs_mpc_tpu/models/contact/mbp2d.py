"""Second-order planar rigid-body dynamics with contact (MBP equivalent).

The TPU-native replacement for the reference's Drake MultibodyPlant backends
(``/root/reference/irs_lqr/mbp_dynamics.py`` — torque-driven, x=(q,v) — and
``mbp_dynamics_position.py`` — PID position-controlled, u = desired
positions, kp=stiffness, kd=0.2*stiffness, ``:54-71``).

One step is Anitescu velocity-level time stepping — the same convex QP layer
as the quasistatic engine, now over the next velocity:

    v_free = v + h M^{-1} tau(q, v, u)
    min_v'  1/2 (v' - v_free)' M (v' - v_free)
    s.t.    (J_n +- mu J_t)(h v') + phi >= 0
    q_next = q + h v',   x_next = (q_next, v')

Geometry, bodies, and contact rows are shared with QuasistaticModel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..base import System
from .qp import solve_qp
from .quasistatic import QuasistaticModel

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class Mbp2DModel:
    """Second-order wrapper around a QuasistaticModel's geometry/config.

    ``base`` supplies bodies, pairs, model instances, gravity.  Masses for
    actuated dofs come from ``actuated_mass`` (the quasistatic model treats
    actuated dofs as massless position-servos; a second-order plant needs
    real inertia).  Damping is a diagonal joint-space viscous term.
    """
    base: QuasistaticModel
    actuated_mass: Tuple[float, ...]
    damping: float = 0.2
    control_mode: str = "position"     # "position" (PID) | "torque"
    kd_ratio: float = 0.2              # reference mbp_dynamics_position.py:63

    @property
    def nq(self):
        return self.base.nq

    @property
    def dim_x(self):
        return 2 * self.base.nq

    @property
    def dim_u(self):
        if self.control_mode == "position":
            return self.base.dim_u
        return self.base.dim_u     # torques on the same actuated dofs

    def _mass_vector(self) -> Array:
        m = np.zeros(self.nq, np.float32)
        ia = 0
        for inst in self.base.models:
            idx = np.asarray(inst.q_indices)
            if inst.actuated:
                m[idx] = np.asarray(
                    self.actuated_mass[ia:ia + len(inst.q_indices)])
                ia += len(inst.q_indices)
            else:
                m[idx] = np.asarray(inst.mass)
        return jnp.asarray(m)

    def _free_velocity(self, q: Array, v: Array, u: Array, M: Array):
        base = self.base
        nq = self.nq
        # Generalized forces (spring/gravity/torque parts only; ALL viscous
        # terms are handled implicitly below — explicit damping is unstable
        # whenever (kd + damping) * h / m > 2, which stiff PD gains hit
        # easily, e.g. Kp=500, kd=100, m=0.3, h=0.01).
        tau = jnp.zeros(nq)
        visc = jnp.full(nq, self.damping)
        gz = jnp.asarray(base.gravity, jnp.float32)
        iu = 0
        for inst in base.models:
            idx = jnp.asarray(inst.q_indices)
            nd = len(inst.q_indices)
            if inst.actuated:
                if self.control_mode == "position":
                    kp = jnp.asarray(inst.stiffness, jnp.float32)
                    kd = self.kd_ratio * kp
                    tau = tau.at[idx].add(kp * (u[iu:iu + nd] - q[idx]))
                    visc = visc.at[idx].add(kd)
                else:
                    tau = tau.at[idx].add(u[iu:iu + nd])
                iu += nd
            else:
                # Gravity on the first two (translation) dofs.
                if nd >= 2:
                    mass = jnp.asarray(inst.mass, jnp.float32)
                    tau = tau.at[idx[0]].add(mass[0] * gz[0])
                    tau = tau.at[idx[1]].add(mass[1] * gz[1])

        # Semi-implicit velocity update with implicit viscous damping:
        #   M (v' - v)/h = tau - visc * v'   =>
        return (v + self.base.h * tau / M) / (1.0 + self.base.h * visc / M)

    def _contact_qp(self, q: Array, v_free: Array, M: Array):
        """(P, b, C, d) of the velocity-level contact QP, or (None, ...)."""
        G, phi = self.base.contact_rows(q)
        if G is None:
            return None, None, None, None
        # min 1/2 v'M v - (M v_free)'v  s.t.  -(h G) v <= phi
        return jnp.diag(M), -(M * v_free), -self.base.h * G, phi

    def step(self, x: Array, u: Array) -> Array:
        nq = self.nq
        q, v = x[:nq], x[nq:]
        M = self._mass_vector()
        v_free = self._free_velocity(q, v, u, M)
        P, b, C, d = self._contact_qp(q, v_free, M)
        if P is None:
            v_next = v_free
        else:
            v_next = solve_qp(P, b, C, d, self.base.qp_iters)
        q_next = q + self.base.h * v_next
        return jnp.concatenate([q_next, v_next])

    def ws_init(self):
        return (jnp.zeros(self.nq, jnp.float32),
                jnp.ones(self.base.n_constraint_rows(), jnp.float32))

    def step_ws(self, x: Array, u: Array, carry):
        """Warm-started step for serial rollouts (see QuasistaticModel
        .step_ws); the carry holds the previous knot's (v', lam)."""
        from .qp import solve_qp_warm
        nq = self.nq
        q, v = x[:nq], x[nq:]
        M = self._mass_vector()
        v_free = self._free_velocity(q, v, u, M)
        P, b, C, d = self._contact_qp(q, v_free, M)
        if P is None:
            v_next = v_free
        else:
            v_next, carry = solve_qp_warm(P, b, C, d, carry,
                                          self.base.qp_iters_ws)
        q_next = q + self.base.h * v_next
        return jnp.concatenate([q_next, v_next]), carry

    def system(self) -> System:
        use_ws = self.base.qp_iters_ws > 0 and bool(self.base.pairs)
        return System(name=f"{self.base.name}_mbp",
                      dim_x=self.dim_x, dim_u=self.dim_u,
                      h=self.base.h, step=self.step,
                      step_ws_fn=self.step_ws if use_ws else None,
                      ws_init_fn=self.ws_init if use_ws else None)

    def indices_u_into_x(self) -> np.ndarray:
        """Actuated POSITION indices into the (q, v) state — used by the
        Δu-cost position-controlled solver (IrsLqrMbpPosition analogue)."""
        return self.base.indices_u_into_x()

    def estimation_surrogate(self, qp_iters: int = 20) -> System:
        """Cheaper system for the Monte-Carlo estimation sweep (pass as
        ``IrsMpcParams.estimation_system``): the velocity-QP solve runs at
        a reduced iteration budget for sample steps AND sample Jacobians.

        The second-order estimation wall is the first-order-A Jacobian
        sweep (reference semantics, mbp_dynamics.py:387-389: A from
        Jacobians averaged over the u-samples) — jacfwd's primal is the
        full PDIP forward per sample, so halving its iterations nearly
        halves the sweep; the implicit-function JVP itself (one KKT solve
        per sample) is iteration-count independent and keeps the
        active-set gradient semantics.  Note the sample rollouts fd share
        the Jacobians' primal via XLA CSE (same points, same solve), so
        routing fd through the Pallas lane kernel would UN-share that
        work — the forward-only kernel family deliberately does not apply
        here.

        MEASURED CAVEAT (r5, why the bundled drivers do NOT wire this in):
        the second-order planar-hand curve finals are basin-chaotic under
        any estimate perturbation.  With 15 iters: spin zero_order_B
        7.40 -> 15.8 (translate improved 7.38 -> 6.11, torque 64.4 ->
        45.2); 20 iters: spin restored (7.42) but torque 64.4 -> 74.3 and
        translate zero_order_AB 9.23 -> 15.2.  Every budget reshuffles
        1-2 of the 9 finals by 1.3-2x in either direction, so the default
        configuration keeps full-accuracy estimation and its reproducible
        committed curves; use this surrogate where wall-clock matters
        more than a specific basin."""
        cheap = dataclasses.replace(
            self, base=dataclasses.replace(self.base, qp_iters=qp_iters))
        return cheap.system()
