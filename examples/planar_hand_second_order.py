"""Planar hand with full second-order dynamics (MBP equivalent).

Mirrors ``/root/reference/examples/planar_hand/run_planar_hand_second_order
{,_position}.py`` driving ``IrsLqrMbp`` / ``IrsLqrMbpPosition``:
x = (q, v) with 14 states; either torque control (plain u'Ru cost, absolute
bounds — ``irs_lqr_mbp.py:246-266``) or PID position control (Δu-cost +
trajectory-centred trust region — ``irs_lqr_mbp_position.py``).

The published reference curves (``analysis/planar_hand{,_spin}_second_
{exact,first,zero}.csv``: 121.83 / 128.50 -> 3.76-3.78 in 11 iterations)
come from the position-controlled driver: h=0.1, T=30, ball translate
(+0.3, -0.1), Q_u = [10, 10, ~0], Qd = 100 Q, R = 5 I, u in nominal +- 0.5
(trust region), std_u = 0.1 with 1/iter^0.8 decay, 50 samples, and a
constant strong-squeeze initial command u0 = (-pi/2+0.5, ..., pi/2-0.5)
(``run_planar_hand_second_order_position.py:100-141``).  The "zero" curve is
zero_order_B with A from AVERAGED FIRST-ORDER Jacobians
(``mbp_dynamics.py:387-389``) — all three published modes use autodiff A;
only B comes from sampling.  ``main`` sweeps those modes plus the joint
zero_order_AB fit (heavier Tikhonov damping: the 14-state A from 50
rollout differences is noise-dominated at damp=1e-10, the reference's
value, and its Riccati blows up in f32).
"""
from common import report

import numpy as np

from irs_mpc_tpu import IrsMpc, IrsMpcParams, SmoothingConfig
from irs_mpc_tpu.models.contact.mbp2d import Mbp2DModel
from irs_mpc_tpu.models.contact.systems import make_planar_hand


def _make_mbp(control_mode):
    base = make_planar_hand(h=0.1)
    return base, Mbp2DModel(base=base, actuated_mass=(0.5, 0.3, 0.5, 0.3),
                            control_mode=control_mode, damping=0.5)


Q0 = np.array([0., 0.35, 0., -np.pi / 4, -np.pi / 4,
               np.pi / 4, np.pi / 4], np.float32)


def build_solver(control_mode="position", num_samples=50, T=30,
                 gradient_mode="zero_order_B", spin=False):
    """Position mode: the reference position driver's translate task
    (ball +(0.3, -0.1), run_planar_hand_second_order_position.py:119-127);
    ``spin=True`` adds the -pi/4 ball rotation with a small theta weight
    (the planar_hand_spin_second_* family, initial cost ~128.5).
    Torque mode: the torque driver's spin task (ball theta -> -pi/4,
    run_planar_hand_second_order.py:96-121) with plain u'Ru cost and
    absolute torque bounds."""
    base, mbp = _make_mbp(control_mode)
    system = mbp.system()
    nq = base.nq
    x0 = np.concatenate([Q0, np.zeros(nq)])
    qd = Q0.copy()

    if control_mode == "position":
        qd[0:2] += np.array([0.3, -0.1])
        Qq = np.array([10., 10., 1e-3, 1e-3, 1e-3, 1e-3, 1e-3])
        if spin:
            qd[2] = -np.pi / 4
            Qq[2] = 0.1
        Q = np.diag(np.concatenate([Qq, np.zeros(nq)]).astype(np.float32))
        idx_u = mbp.indices_u_into_x()
        # Constant strong-squeeze initial command (reference :76-87).
        u0 = np.array([-np.pi / 2 + 0.5] * 2 + [np.pi / 2 - 0.5] * 2,
                      np.float32)
        extra = dict(indices_u_into_x=idx_u,
                     u_bounds_abs=np.array([-np.ones(4) * 0.5,
                                            np.ones(4) * 0.5]),
                     bounds_trust_region=True,
                     R=np.eye(4) * 5.0)
        smoothing = SmoothingConfig(
            num_samples=num_samples, std_u=0.1, std_x=1e-3,
            decay=lambda it: 1.0 / it ** 0.8, decay_std_x=False,
            damp=3e-3, zero_order_B_A_source="first_order")
    else:
        # Torque-mode spin task (reference torque driver).
        qd[2] = -np.pi / 4
        Qq = np.array([10., 10., 10., 0., 0., 0., 0.])
        Q = np.diag(np.concatenate([Qq, np.zeros(nq)]).astype(np.float32))
        u0 = np.zeros(4, np.float32)
        extra = dict(u_bounds_abs=np.array([-np.ones(4) * 10.0,
                                            np.ones(4) * 10.0]),
                     R=np.eye(4) * 0.05)
        smoothing = SmoothingConfig(
            num_samples=num_samples, std_u=0.4, std_x=1e-3,
            decay=lambda it: 0.4 ** (0.5 * it) / 0.4, decay_std_x=False,
            damp=3e-3, zero_order_B_A_source="first_order")

    xd = np.concatenate([qd, np.zeros(nq)])
    params = IrsMpcParams(
        Q=Q, Qd=Q * 100,
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        u_trj_init=np.tile(u0, (T, 1)),
        unactuated_indices=np.array([0, 1, 2]),
        gradient_mode=gradient_mode,
        smoothing=smoothing,
        admm_iters=30,
        report_final_cost_with_Q=False,
        # NOTE: mbp.estimation_surrogate() exists but is deliberately NOT
        # wired here — see its docstring for the measured basin chaos
        # (every surrogate budget reshuffles 1-2 of the 9 second-order
        # curve finals by 1.3-2x in either direction).
        **extra,
    )
    return IrsMpc(system, params), mbp


def build_cem_solver(control_mode="position", T=30, batch_size=16000,
                     n_elite=160, spin=False):
    """CEM on the second-order plant — the reference's
    ``run_planar_hand_second_order{,_position}_cem.py`` drivers
    (``CrossEntropyMethodMbp`` / ``CrossEntropyMethodMbpPosition``,
    ``irs_lqr/cem_mbp{,_position}.py``): Δu-cost + input clipping in
    position mode, plain u'Ru in torque mode.  Same translate task as the
    iRS position sweep."""
    from irs_mpc_tpu.solvers.cem import CemParams, CrossEntropyMethod
    base, mbp = _make_mbp(control_mode)
    system = mbp.system()
    nq = base.nq
    x0 = np.concatenate([Q0, np.zeros(nq)])
    qd = Q0.copy()

    if control_mode == "position":
        qd[0:2] += np.array([0.3, -0.1])
        Qq = np.array([10., 10., 1e-3, 1e-3, 1e-3, 1e-3, 1e-3])
        if spin:
            qd[2] = -np.pi / 4
            Qq[2] = 0.1
        idx_u = mbp.indices_u_into_x()
        extra = dict(indices_u_into_x=idx_u, R=np.eye(4) * 5.0,
                     u_trj_init=np.tile(Q0[idx_u], (T, 1)),
                     initial_std=np.ones(4) * 0.15)
        # iCEM-class knobs (see solvers/cem.py): with an accelerator-sized
        # population this search brackets the plant's floor at ~5.7
        # (16k/300 -> 5.71, 8k/600 -> 5.95), right where the iRS sweep
        # lands (6.07) and far above the reference's 3.76 on ITS geometry
        # — the empirical leg of PARITY.md's second-order floor analysis.
        extra.update(noise_beta=0.7, momentum=0.1,
                     elite_keep=max(1, n_elite // 8),
                     std_floor=np.ones(4) * 0.01)
    else:
        if spin:
            raise ValueError(
                "spin=True only applies to control_mode='position'; the "
                "torque branch hard-codes the spin task (qd[2] = -pi/4).")
        qd[2] = -np.pi / 4
        Qq = np.array([10., 10., 10., 0., 0., 0., 0.])
        extra = dict(R=np.eye(4) * 0.05,
                     u_trj_init=np.zeros((T, 4), np.float32),
                     initial_std=np.ones(4) * 2.0)
    Q = np.diag(np.concatenate([Qq, np.zeros(nq)]).astype(np.float32))
    xd = np.concatenate([qd, np.zeros(nq)])

    params = CemParams(
        Q=Q, Qd=Q * 100,
        x0=x0, xd_trj=np.tile(xd, (T + 1, 1)),
        n_elite=n_elite, batch_size=batch_size,
        report_final_cost_with_Q=False, **extra)
    return CrossEntropyMethod(system, params), mbp


# The reference's published per-mode set; zero_order_AB is our extra.
MODES = ("exact", "first_order", "zero_order_B", "zero_order_AB")


def main(num_iters=15):
    # Per-gradient-mode position-controlled sweep (the published family).
    for spin, prefix in ((False, "planar_hand_second"),
                         (True, "planar_hand_spin_second")):
        for mode in MODES:
            solver, mbp = build_solver(gradient_mode=mode, spin=spin)
            solver.iterate(num_iters, verbose=False)
            report(solver, f"{prefix}_{mode}")
            print(f"  [{mode}] ball final:", solver.x_trj_best[-1][:3])
    # Torque-mode spin (IrsLqrMbp analogue) + CEM baseline.
    solver, mbp = build_solver(control_mode="torque")
    solver.iterate(num_iters, verbose=False)
    report(solver, "planar_hand_second_torque")
    print("  [torque] ball final:", solver.x_trj_best[-1][:3])
    cem, mbp = build_cem_solver()
    cem.iterate(300, verbose=False)
    report(cem, "planar_hand_second_cem")
    print("  [cem] ball final:", cem.x_trj_best[-1][:3])
    cem, mbp = build_cem_solver(spin=True)
    cem.iterate(300, verbose=False)
    report(cem, "planar_hand_spin_second_cem")
    print("  [spin cem] ball final:", cem.x_trj_best[-1][:3])


if __name__ == "__main__":
    main()
