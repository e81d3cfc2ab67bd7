"""Plate pickup: gripper grasps a plate off the ground and lifts it.

Mirrors ``/root/reference/examples/plate_pickup/run_plate_pickup.py``
(dim_x=8, dim_u=5, uses relative input bounds u_bounds_rel,
``run_plate_pickup.py:136-137``).
"""
from common import report

import dataclasses

import numpy as np

from irs_mpc_tpu import IrsMpc, IrsMpcParams, SmoothingConfig
from irs_mpc_tpu.models.contact.systems import make_plate_pickup


def build_solver(gradient_mode="zero_order_B", num_samples=100, T=30):
    model = make_plate_pickup(h=0.1)
    system = model.system()
    idx_u = model.indices_u_into_x()

    # Plate on the ground; gripper hovering above it, fingers open with a
    # 0.02 clearance from the plate's side faces (slide -0.16 puts finger
    # centers at x = +-0.46; plate half-width 0.4, finger radius 0.04).
    q0 = {"plate": np.array([0.0, 0.04, 0.0]),
          "gripper": np.array([0.0, 0.30, 0.0, -0.16, -0.16])}
    x0 = model.get_x_from_q_dict(q0)
    # Staged desired trajectory (x_trj_d is a full trajectory in the API,
    # like the reference's): phase 1 (first third) — squeeze the fingers on
    # the resting plate; phase 2 — ramp gripper and plate upward together.
    # A constant lifted-goal gives the one-step bundled gradient no reason
    # to close the fingers first (observed: it drags the plate sideways).
    T1 = T // 3
    xd_rows = []
    for t in range(T + 1):
        if t <= T1:
            g = np.array([0.0, 0.30, 0.0, 0.02, 0.02])
            plate = np.array([0.0, 0.04, 0.0])
        else:
            frac = (t - T1) / max(T - T1, 1)
            lift = 0.3 * frac
            g = np.array([0.0, 0.30 + lift, 0.0, 0.02, 0.02])
            plate = np.array([0.0, 0.04 + lift, 0.0])
        xd_rows.append(model.get_x_from_q_dict(
            {"plate": plate, "gripper": g}))
    xd_trj = np.stack(xd_rows)
    xd = xd_trj[-1]

    Q_dict = {"plate": np.array([1.0, 50.0, 5.0]),
              "gripper": np.array([0.1, 0.1, 0.1, 0.5, 0.5])}
    Qd_dict = {k: v * 100 for k, v in Q_dict.items()}
    R_dict = {"gripper": np.array([1.0, 1.0, 1.0, 0.2, 0.2])}

    params = IrsMpcParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict(Qd_dict),
        R=model.get_R_from_R_dict(R_dict),
        x0=x0, xd_trj=xd_trj,
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        u_bounds_rel=np.array([-np.ones(5) * 0.06, np.ones(5) * 0.06]),
        indices_u_into_x=idx_u,
        unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode,
        decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.1, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False),
        admm_iters=30,
        report_final_cost_with_Q=False,
        # Cheaper contact solves for the (noisy) Monte-Carlo sweep
        # (reduced QP iterations + the fused sweep hook).
        estimation_system=model.estimation_surrogate(),
    )
    return IrsMpc(system, params), model


def main():
    solver, model = build_solver()
    solver.iterate(10, verbose=False)
    report(solver, "plate_pickup_zero_order")
    print("plate final:", solver.x_trj_best[-1][:3])


if __name__ == "__main__":
    main()
