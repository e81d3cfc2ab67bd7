"""Planar hand with the CEM baseline (contact-rich CEM).

Mirrors ``/root/reference/examples/planar_hand/run_planar_hand_cem.py``
(CrossEntropyMethodQuasistatic: Δu-cost, input clipping, best-tracking).
"""
from common import report

import numpy as np

from irs_mpc_tpu.models.contact.systems import make_planar_hand
from irs_mpc_tpu.solvers.cem import CemParams, CrossEntropyMethod


def build_solver(T=30, batch_size=2000, n_elite=100):
    """Population sized for an accelerator (the reference's 100 serial
    python rollouts -> 2000 vmapped contact rollouts) with the
    iCEM-class knobs from solvers/cem.py (default-off).  Sweep on this task:
    vanilla 100/15 -> 17.4; this config -> 6.9 — BELOW the iRS smoothed
    floor (14.5-14.7): the AR(1)-correlated arm motions find a faster ball
    transit than the trust-regioned local descent."""
    model = make_planar_hand(h=0.1)
    system = model.system()
    idx_u = model.indices_u_into_x()

    q0 = {"sphere": np.array([0.0, 0.35, 0.0]),
          "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
          "arm_right": np.array([np.pi / 4, np.pi / 4])}
    x0 = model.get_x_from_q_dict(q0)
    xd_dict = {"sphere": q0["sphere"] + np.array([0.3, -0.1, 0.5]),
               "arm_left": q0["arm_left"], "arm_right": q0["arm_right"]}
    xd = model.get_x_from_q_dict(xd_dict)

    Q_dict = {"sphere": np.array([1e-3, 1e-3, 10.0]),
              "arm_left": np.array([1e-3, 1e-3]),
              "arm_right": np.array([1e-3, 1e-3])}
    Qd_dict = {k: v * 100 for k, v in Q_dict.items()}
    R_dict = {"arm_left": 5 * np.array([1.0, 1.0]),
              "arm_right": 5 * np.array([1.0, 1.0])}

    params = CemParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict(Qd_dict),
        R=model.get_R_from_R_dict(R_dict),
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        n_elite=n_elite, batch_size=batch_size,
        initial_std=np.ones(4) * 0.25,
        std_floor=np.float32(0.02), momentum=0.3, noise_beta=0.85,
        elite_keep=min(10, n_elite),
        indices_u_into_x=idx_u,
        report_final_cost_with_Q=False)
    return CrossEntropyMethod(system, params), model


def main():
    solver, model = build_solver()
    solver.iterate(40, verbose=False)
    report(solver, "planar_hand_cem")
    print("ball final:", solver.x_trj_best[-1][:3])


if __name__ == "__main__":
    main()
