"""Planar hand: two 2-link arms reposition + rotate a ball.

Mirrors ``/root/reference/examples/planar_hand/run_planar_hand.py``: same
task (move the ball by (+0.3, -0.1), rotate +0.5 rad), same cost weights
(Q_dict/Qd_dict/R_dict, ``run_planar_hand.py:117-131``), same trust region
(u bounds +-0.5h), same std schedule (0.3/iter^0.8), same sample budget (50),
Δu-cost position-controlled mode, decoupled AB — but running as a single
on-device program instead of 18 ZMQ worker processes.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dataclasses

import numpy as np

from irs_mpc_tpu import IrsMpc, IrsMpcParams, SmoothingConfig
from irs_mpc_tpu.models.contact.systems import make_planar_hand


def build_solver(gradient_mode="zero_order_B", num_samples=50, T=30,
                 num_iters_hint=10, **overrides):
    """``overrides`` are applied onto the assembled IrsMpcParams
    (dataclasses.replace) — used by the floor-probe drivers to swap the
    initial trajectory, smoothing schedule, or trust region without
    duplicating the task definition."""
    model = make_planar_hand(h=0.1)
    system = model.system()
    idx_u = model.indices_u_into_x()

    # Initial configuration: ball resting between the upturned arms.
    q0 = {"sphere": np.array([0.0, 0.35, 0.0]),
          "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
          "arm_right": np.array([np.pi / 4, np.pi / 4])}
    x0 = model.get_x_from_q_dict(q0)

    # Goal: ball moves (+0.3, -0.1) and rotates +0.5 (run_planar_hand.py:133).
    xd_dict = {"sphere": q0["sphere"] + np.array([0.3, -0.1, 0.5]),
               "arm_left": q0["arm_left"], "arm_right": q0["arm_right"]}
    xd = model.get_x_from_q_dict(xd_dict)
    x_trj_d = np.tile(xd, (T + 1, 1))

    Q_dict = {"sphere": np.array([1e-3, 1e-3, 10.0]),
              "arm_left": np.array([1e-3, 1e-3]),
              "arm_right": np.array([1e-3, 1e-3])}
    Qd_dict = {k: v * 100 for k, v in Q_dict.items()}
    R_dict = {"arm_left": 5 * np.array([1.0, 1.0]),
              "arm_right": 5 * np.array([1.0, 1.0])}

    u0 = x0[idx_u]
    u_trj_init = np.tile(u0, (T, 1))

    params = IrsMpcParams(
        Q=model.get_Q_from_Q_dict(Q_dict),
        Qd=model.get_Q_from_Q_dict(Qd_dict),
        R=model.get_R_from_R_dict(R_dict),
        x0=x0, xd_trj=x_trj_d, u_trj_init=u_trj_init,
        u_bounds_abs=np.array([-np.ones(4) * 0.5 * model.h,
                               np.ones(4) * 0.5 * model.h]),
        bounds_trust_region=True,
        indices_u_into_x=idx_u,
        unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode,
        decouple_AB=True,
        smoothing=SmoothingConfig(
            num_samples=num_samples, std_u=0.3, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False),
        # Over-relaxed ADMM (a=1.6) needs 12 sweeps where plain needs 30:
        # per-mode finals at (12, 1.6) = 17.18/14.54/14.51/14.89 vs
        # (30, 1.0) = 17.03/14.62/14.72/14.76 — equal within sampling noise,
        # at fewer serial sweeps per iteration.
        admm_iters=12,
        admm_over_relax=1.6,
        report_final_cost_with_Q=False,   # quasistatic path uses Qd
        # Cheaper contact solves for the (noisy) Monte-Carlo sweep
        # (reduced QP iterations + the fused sweep hook).
        estimation_system=model.estimation_surrogate(),
    )
    if overrides:
        params = dataclasses.replace(params, **overrides)
    return IrsMpc(system, params), model


MODES = ("exact", "first_order", "zero_order_B", "zero_order_AB")


def main(modes=MODES, num_iters=21):
    """Sweep the reference's four gradient modes, saving one cost curve per
    mode (planar_hand_{exact,first_order,zero_order_B,zero_order_AB}.csv,
    the reference's §6 curves where exact gets stuck at ~61 while the
    smoothed modes reach ~11)."""
    from common import report
    solver = None
    for mode in modes:
        solver, model = build_solver(gradient_mode=mode)
        solver.iterate(num_iters, verbose=False)
        report(solver, f"planar_hand_{mode}")
        xf = solver.x_trj_best[-1]
        print(f"  [{mode}] ball final:", xf[:3],
              "goal:", np.asarray(solver.xd_trj[-1][:3]))
    return solver


if __name__ == "__main__":
    main()
