"""Planar hand 'spin' task: rotate the ball -pi/4 while lowering it.

Mirrors ``/root/reference/examples/planar_hand/run_planar_hand_spin.py``:
Q = [10, 1, 10] on the ball, Qd = 10 Q (NOT 100, unlike the base task),
R = 1e2, goal = ball rotates -pi/4 and descends, u in nominal +- 1.0 h,
std_u 0.1 with 1/sqrt(iter) decay, 50 samples
(``run_planar_hand_spin.py:118-150``).

Calibration note: the reference ball starts held at (0, 0.6) and descends
-0.2; our geometry's resting height is (0, 0.35) (see
``systems.make_planar_hand``), so the descent is -0.1 (onto the ground,
z = 0.25).  The initial cost is theta/z-dominated and matches the
reference's published 249.63 (``analysis/planar_hand_spin_exact.csv:1``)
to within ~1%: static rollout = 30 x (10 (pi/4)^2 + 1 (0.1)^2) running
+ 10x that final.
"""
from common import report

import numpy as np

from irs_mpc_tpu import IrsMpc, IrsMpcParams, SmoothingConfig
from irs_mpc_tpu.models.contact.systems import make_planar_hand

GOAL = np.array([0.0, -0.1, -np.pi / 4])


def _task(model, T):
    q0 = {"sphere": np.array([0.0, 0.35, 0.0]),
          "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
          "arm_right": np.array([np.pi / 4, np.pi / 4])}
    x0 = model.get_x_from_q_dict(q0)
    xd_dict = {"sphere": q0["sphere"] + GOAL,
               "arm_left": q0["arm_left"], "arm_right": q0["arm_right"]}
    xd = model.get_x_from_q_dict(xd_dict)
    Q_dict = {"sphere": np.array([10.0, 1.0, 10.0]),
              "arm_left": np.array([1e-3, 1e-3]),
              "arm_right": np.array([1e-3, 1e-3])}
    Qd_dict = {k: v * 10 for k, v in Q_dict.items()}
    R_dict = {"arm_left": 1e2 * np.ones(2), "arm_right": 1e2 * np.ones(2)}
    return x0, np.tile(xd, (T + 1, 1)), Q_dict, Qd_dict, R_dict


def build_solver(gradient_mode="zero_order_B", num_samples=50, T=30):
    model = make_planar_hand(h=0.1)
    idx_u = model.indices_u_into_x()
    x0, xd_trj, Q_dict, Qd_dict, R_dict = _task(model, T)
    params = IrsMpcParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict(Qd_dict),
        R=model.get_R_from_R_dict(R_dict),
        x0=x0, xd_trj=xd_trj,
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        u_bounds_abs=np.array([-np.ones(4) * 1.0 * model.h,
                               np.ones(4) * 1.0 * model.h]),
        bounds_trust_region=True,
        indices_u_into_x=idx_u,
        unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode,
        decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.1, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.5, decay_std_x=False),
        admm_iters=30,
        report_final_cost_with_Q=False,
        estimation_system=model.estimation_surrogate(),
    )
    return IrsMpc(model.system(), params), model


def build_cem_solver(T=30, batch_size=2000, n_elite=100):
    """CEM on the spin task (run_planar_hand_spin_cem.py: n_elite=5,
    batch 100, initial_std 0.2, Qd = 10 Q).

    The reference's 100-trajectory population is sized for serial python
    rollouts; on an accelerator a 2000-wide contact population is one
    vmapped program, and the iCEM-class knobs (AR(1) noise beta=0.85, refit
    momentum, elite persistence, std floor — solvers/cem.py, default-off)
    turn the spin search from a 175-cost plateau into 37 — BELOW the best
    iRS smoothed mode (53).  Sweep: vanilla/100 -> 175.3, vanilla/1000 ->
    55.0, this config -> 37.3."""
    from irs_mpc_tpu.solvers.cem import CemParams, CrossEntropyMethod
    model = make_planar_hand(h=0.1)
    idx_u = model.indices_u_into_x()
    x0, xd_trj, Q_dict, Qd_dict, R_dict = _task(model, T)
    params = CemParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict(Qd_dict),
        R=model.get_R_from_R_dict(R_dict),
        x0=x0, xd_trj=xd_trj,
        u_trj_init=np.tile(x0[idx_u], (T, 1)),
        n_elite=n_elite, batch_size=batch_size,
        initial_std=np.ones(4) * 0.25,
        std_floor=np.float32(0.02), momentum=0.3, noise_beta=0.85,
        elite_keep=min(10, n_elite),
        indices_u_into_x=idx_u,
        report_final_cost_with_Q=False)
    return CrossEntropyMethod(model.system(), params), model


MODES = ("exact", "first_order", "zero_order_B", "zero_order_AB")


def main(modes=MODES, num_iters=21):
    """Sweep the reference's spin-task modes, one curve per mode
    (planar_hand_spin_{exact,first_order,zero_order_B,zero_order_AB}.csv,
    ref: 249.63 -> 63.79 / 62.73 / 116.33 / 53.51 over 22 rows — note the
    reference's OWN zero_order_B is its worst spin mode; at the matched
    iteration budget we land at 86.9 (exact plateaus — smoothing wins,
    the reference's own story) / 53.5 / see CSV / 55.1)."""
    solver = None
    for mode in modes:
        solver, model = build_solver(gradient_mode=mode)
        solver.iterate(num_iters, verbose=False)
        report(solver, f"planar_hand_spin_{mode}")
        print(f"  [{mode}] ball final:", solver.x_trj_best[-1][:3],
              "(goal", GOAL, ")")
    # CEM baseline (run_planar_hand_spin_cem.py analogue).
    cem, model = build_cem_solver()
    cem.iterate(40, verbose=False)
    report(cem, "planar_hand_spin_cem")
    print("  [cem] ball final:", cem.x_trj_best[-1][:3])
    return solver


if __name__ == "__main__":
    main()
