"""Smoke run of iRS-MPC on one NVIDIA GPU, through the normal entry points.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --four-gpus # four GPUs: the mesh-sharded path only

Phases (one JSON line each, on stdout):

1. device    — nvidia-smi's name and power limit, JAX's devices.  There is
               no CPU fallback: without a GPU the script exits nonzero.
2. pendulum  — T=200, 1,000 samples per knot, std 1.0: 9 iterations in
               zero_order and 9 in exact.  Initial cost = the committed
               curve's first row (rel 1e-4), final <= 360; ms/iteration
               with one device sync per descent; the Riccati share.
3. planar_hand — examples/planar_hand.py (quasistatic contact, T=30, 50
               samples, zero_order_B, decouple_AB, boxed ADMM 12 x 1.6,
               6-alpha warm-started rollout), 20 iterations: initial cost
               within 0.1% of the committed curve, best <= 32.5 (10x drop);
               then 3 iterations of the second-order planar hand.
4. phase_split — the planar-hand iteration's phases, each as its own jitted
               call at the iteration's shapes, and their shares.
5. kernel    — the whole-loop ADMM GPU kernel against the XLA path on the
               captured planar-hand QP and a bicycle-hard-style QP with all
               four bound kinds, both against the f64 C++ oracle at 200
               sweeps; both paths' times, end to end too.

Any failure raises, so the exit is nonzero and the last line is never
printed.  The last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEND_T, PEND_S = 200, 1000


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def first_row(name):
    return float(np.loadtxt(ROOT / "examples" / "analysis" / f"{name}.csv",
                            delimiter=",")[0])


def device_phase():
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (backend "
                         f"{jax.default_backend()!r}); nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    for line in smi.strip().splitlines():
        print(line.strip(), flush=True)
    emit("device", nvidia_smi=smi.strip().splitlines(),
         devices=[str(d) for d in jax.devices()],
         device_kind=[d.device_kind for d in jax.devices()],
         jax_version=jax.__version__)


def time_chained(step, state, n, reps=3):
    """ms per call of ``state = step(*state)`` chained ``n`` times with ONE
    device sync at the end (as a descent runs); median over ``reps``."""
    import jax
    jax.block_until_ready(step(*state))          # compile outside the clock
    ts = []
    for _ in range(reps):
        s = state
        t0 = time.perf_counter()
        for _ in range(n):
            s = step(*s)
        jax.block_until_ready(s)
        ts.append((time.perf_counter() - t0) / n * 1e3)
    return float(np.median(ts)), ts


def time_calls(fn, *args, n=20, reps=3):
    """ms per call of independent calls on fixed inputs, synced per block."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / n * 1e3)
    return float(np.median(ts)), ts


def iteration_step(solver, it=2.0):
    import jax.numpy as jnp
    it = jnp.asarray(it, jnp.float32)

    def step(x, u, key):
        x, u, key, _ = solver._iteration_jit(x, u, key, it)
        return x, u, key
    return step


def pendulum_params(mode, mesh=None):
    from irs_mpc_tpu import IrsMpcParams, SmoothingConfig
    T = PEND_T
    return IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)), gradient_mode=mode, mesh=mesh,
        smoothing=SmoothingConfig(num_samples=PEND_S, std_x=1.0, std_u=1.0))


def pendulum_phase():
    import jax
    from irs_mpc_tpu import IrsMpc, make_pendulum
    from irs_mpc_tpu.ops import lqr as lqr_ops

    want0 = first_row("pendulum_zero_order")
    for mode in ("zero_order", "exact"):
        solver = IrsMpc(make_pendulum(0.05), pendulum_params(mode))
        t0 = time.perf_counter()
        solver.iterate(9, verbose=False)
        wall = time.perf_counter() - t0
        c0, cf = solver.cost_lst[0], solver.cost
        check(abs(c0 - want0) <= 1e-4 * want0,
              f"pendulum {mode}: initial cost {c0} != {want0}")
        check(np.isfinite(cf) and cf <= 360.0,
              f"pendulum {mode}: final cost {cf} > 360")
        x0, u0 = solver.x_trj_lst[0], solver.u_trj_lst[0]
        ms, ts = time_chained(iteration_step(solver, 1.0),
                              (x0, u0, jax.random.PRNGKey(0)), 9)
        fields = {}
        if mode == "zero_order":
            # The unconstrained Riccati pass + linear rollout at the
            # iteration's own shapes, as a share of the whole iteration.
            with jax.default_matmul_precision("highest"):
                tv = jax.jit(solver._estimate)(
                    x0, u0, jax.random.PRNGKey(1), 1.0)
                prob = solver._build_problem(tv, x0)
                r_ms, _ = time_calls(jax.jit(lqr_ops.lqr_solve), prob)
            fields = dict(riccati_ms=r_ms, riccati_share=r_ms / ms)
        emit("pendulum", mode=mode, T=PEND_T, samples=PEND_S,
             initial_cost=c0, final_cost=cf, reference_initial=want0,
             ms_per_iter=ms, ms_per_iter_reps=ts,
             iterate_wall_s_incl_compile=wall, **fields)


def planar_hand_phase():
    import planar_hand
    import planar_hand_second_order

    solver, _ = planar_hand.build_solver()
    solver.iterate(20, verbose=False)
    c0, best = solver.cost_lst[0], solver.cost_best
    want0 = first_row("planar_hand_zero_order_B")
    check(abs(c0 - want0) <= 1e-3 * want0,
          f"planar hand: initial cost {c0} not within 0.1% of {want0}")
    check(best <= 32.5, f"planar hand: best cost {best} > 32.5")
    ms, ts = time_chained(iteration_step(solver),
                          (solver.x_trj_lst[1], solver.u_trj_lst[1],
                           solver.key), 10)
    emit("planar_hand", iterations=20, initial_cost=c0,
         reference_initial=want0, best_cost=best, final_cost=solver.cost,
         ms_per_iter=ms, ms_per_iter_reps=ts)

    so, _ = planar_hand_second_order.build_solver(
        control_mode="position", num_samples=50, T=30)
    so.iterate(3, verbose=False)
    costs = np.asarray(so.cost_lst)
    best_so_far = np.minimum.accumulate(costs)
    check(np.all(np.isfinite(costs)), f"second order: costs {costs}")
    check(np.all(np.diff(best_so_far) <= 0) and so.cost_best <= costs[0],
          f"second order: best-so-far rose {costs}")
    ms2, ts2 = time_chained(iteration_step(so),
                            (so.x_trj_lst[1], so.u_trj_lst[1], so.key), 5)
    emit("planar_hand_second_order", iterations=3, costs=costs.tolist(),
         ms_per_iter=ms2, ms_per_iter_reps=ts2)
    return solver


def phase_split(solver):
    """Each phase of the planar-hand iteration as its own jitted call, on
    the inputs the iteration itself sees (after one descent)."""
    import jax
    import jax.numpy as jnp
    from irs_mpc_tpu.ops.estimators import (decouple_AB, draw_perturbations,
                                            fit_sweep)

    p = solver.params
    est = p.estimation_system
    x, u = solver.x_trj_lst[1], solver.u_trj_lst[1]
    it = jnp.asarray(2.0, jnp.float32)
    key = jax.random.PRNGKey(3)
    hi = lambda f: jax.jit(lambda *a: _highest(f, *a))

    dx, du = draw_perturbations(est, x, u, key, it, p.smoothing)
    sweep = hi(lambda x, u, du: est.est_sweep_fn(x[:-1], u, None, du))
    f_nom, fd = sweep(x, u, du)
    fit = hi(lambda x, u, dx, du, f_nom, fd: decouple_AB(
        fit_sweep(est, p.gradient_mode, x, u, dx, du, f_nom, fd,
                  p.smoothing, need_A=False)[0],
        solver.idx_u, x, u, solver.system, f_nom=f_nom))
    tv = fit(x, u, dx, du, f_nom, fd)
    qp = hi(lambda tv, x: solver._plan(solver._build_problem(tv, x), x))
    gains, z_plan, u_plan = qp(tv, x)
    roll = hi(solver._line_search)

    times = {
        "estimation_sweep": time_calls(sweep, x, u, du)[0],
        "fit_decouple_AB": time_calls(fit, x, u, dx, du, f_nom, fd)[0],
        "boxed_admm": time_calls(qp, tv, x)[0],
        "forward_rollout_6_lanes": time_calls(roll, x, u, gains, z_plan,
                                              u_plan)[0],
    }
    full = time_calls(solver._iteration_jit, x, u, key, it)[0]
    emit("phase_split", iteration_ms=full, phase_ms=times,
         phase_share={k: v / full for k, v in times.items()})
    return tv


def _highest(f, *args, **kwargs):
    import jax
    with jax.default_matmul_precision("highest"):
        return f(*args, **kwargs)


def bicycle_hard_solver():
    """The bicycle's hard goal (examples/bicycle.py: behind the car, steering
    bound +-pi/4) with relative state and input boxes added, so the QP
    carries all four bound kinds; T cut to 40 to keep the f64 oracle small."""
    from irs_mpc_tpu import IrsMpc, IrsMpcParams, SmoothingConfig, make_bicycle
    T = 40
    xd = np.array([-3., -1., -np.pi / 2, 0., 0.])
    params = IrsMpcParams(
        Q=np.diag([5., 5., 3., 0.1, 0.1]), Qd=np.diag([50., 50., 30., 1., 1.]),
        R=np.diag([1., 0.1]), x0=np.zeros(5),
        xd_trj=np.tile(xd, (T + 1, 1)), u_trj_init=np.tile([0.1, 0.0], (T, 1)),
        x_bounds_abs=np.array([[-1e4, -1e4, -1e4, -1e4, -np.pi / 4],
                               [1e4, 1e4, 1e4, 1e4, np.pi / 4]]),
        u_bounds_abs=np.array([[-1e4, -1e4], [1e4, 1e4]]),
        x_bounds_rel=np.array([[-1.0] * 5, [1.0] * 5]),
        u_bounds_rel=np.array([[-1.0, -0.5], [1.0, 0.5]]),
        gradient_mode="exact", admm_iters=40, admm_over_relax=1.6,
        smoothing=SmoothingConfig(num_samples=8))
    return IrsMpc(make_bicycle(0.1), params)


def kernel_phase(planar, planar_tv):
    import jax
    from irs_mpc_tpu.native import boxed_tvlqr_oracle
    from irs_mpc_tpu.ops import admm as admm_ops

    bike = bicycle_hard_solver()
    bx, bu = bike.x_trj, bike.u_trj
    bike_tv = jax.jit(bike._estimate)(bx, bu, jax.random.PRNGKey(0), 1.0)
    # (name, solver, nominal, linearization, rho of the 200-sweep oracle
    # check: the penalty changes the ADMM path, not the QP's optimum; at
    # the planar hand's own rho=1, 200 sweeps leave its primal residual
    # near 1e-2, at rho=5 near 1e-4.)
    cases = [("planar_hand", planar, planar.x_trj_lst[1], planar_tv, 5.0),
             ("bicycle_hard_4kinds", bike, bx, bike_tv, 1.0)]
    for name, solver, x, tv, rho_conv in cases:
        p = solver.params
        n, m = solver.system.dim_x, solver.system.dim_u
        prob = solver._build_problem(tv, x)
        bounds = solver._box_bounds(x)
        n_aug = prob.A.shape[1]
        idx_w = np.arange(n, n_aug) if n_aug > n else None
        kinds = [k for k in admm_ops._SVals._fields
                 if getattr(bounds, k) is not None]

        def solver_fn(kernel, iters, rho=p.admm_rho):
            return jax.jit(lambda prob, bounds: _highest(
                admm_ops.solve_boxed_tvlqr, prob, bounds, n_phys=n,
                idx_w=idx_w, rho=rho, iters=iters,
                over_relax=p.admm_over_relax, kernel=kernel))

        fk, fx = solver_fn(True, p.admm_iters), solver_fn(False, p.admm_iters)
        k, r = fk(prob, bounds), fx(prob, bounds)
        for f in ("u_trj", "x_trj"):
            np.testing.assert_allclose(getattr(k, f), getattr(r, f),
                                       rtol=1e-3, atol=1e-3, err_msg=name + f)
        np.testing.assert_allclose(k.gains.K, r.gains.K, rtol=1e-3,
                                   atol=1e-3, err_msg=name + " K")
        np.testing.assert_allclose(float(k.r_primal), float(r.r_primal),
                                   rtol=1e-2, err_msg=name + " r_primal")
        k_ms, _ = time_calls(fk, prob, bounds)
        x_ms, _ = time_calls(fx, prob, bounds)

        k200 = solver_fn(True, 200, rho=rho_conv)(prob, bounds)
        r200 = solver_fn(False, 200, rho=rho_conv)(prob, bounds)
        x_or, u_or = boxed_tvlqr_oracle(prob, bounds, n_phys=n, idx_w=idx_w)
        errs = {}
        for label, sol in (("kernel", k200), ("xla", r200)):
            np.testing.assert_allclose(sol.u_trj, u_or, rtol=5e-3, atol=5e-3,
                                       err_msg=f"{name} {label} u vs oracle")
            np.testing.assert_allclose(sol.x_trj, x_or, rtol=5e-3, atol=5e-3,
                                       err_msg=f"{name} {label} x vs oracle")
            errs[label] = max(float(np.abs(sol.u_trj - u_or).max()),
                              float(np.abs(sol.x_trj - x_or).max()))
        emit("kernel", problem=name, T=int(prob.B.shape[0]), n_aug=n_aug,
             m=m, kinds=kinds, sweeps=p.admm_iters, kernel_ms=k_ms,
             xla_ms=x_ms, max_err_200_sweeps_vs_f64_oracle=errs,
             r_primal_200={"kernel": float(k200.r_primal),
                           "xla": float(r200.r_primal)},
             precision="kernel: f32 multiply-add on CUDA cores; XLA: f32 "
                       "under default_matmul_precision('highest') (no TF32)")

    # End to end: the planar-hand iteration with the kernel and with XLA's
    # loops, alternating, in this process on this card.
    import planar_hand
    iters = {}
    for kernel in (None, False, None, False):
        s, _ = planar_hand.build_solver(admm_kernel=kernel)
        ms, _ = time_chained(iteration_step(s), (s.x_trj, s.u_trj, s.key), 10)
        iters.setdefault("kernel" if kernel is None else "xla", []).append(ms)
    emit("kernel_end_to_end", planar_hand_ms_per_iter=iters)
    check(min(iters["kernel"]) < min(iters["xla"]),
          f"ADMM kernel not faster end to end: {iters}")


# ---- four GPUs: the mesh-sharded estimation path ---------------------------

def _four_gpu_configs(mesh_fn):
    import planar_hand
    from irs_mpc_tpu import IrsMpc, make_pendulum
    pend = IrsMpc(make_pendulum(0.05),
                  pendulum_params("zero_order", mesh=mesh_fn(4, 1)))
    hand, _ = planar_hand.build_solver(mesh=mesh_fn(2, 2))
    return {"pendulum": pend, "planar_hand": hand}


def _first_tv(solver):
    import jax
    _, k_est = jax.random.split(solver.key)
    tv = jax.jit(lambda x, u, k: _highest(solver._estimate, x, u, k, 1.0))(
        solver.x_trj, solver.u_trj, k_est)
    return {f: np.asarray(getattr(tv, f)) for f in ("A", "B", "c")}


def cpu_reference(out_path):
    """Child process, CPU only: first-iteration A, B, c on 4 virtual CPU
    devices with the same mesh shapes."""
    from irs_mpc_tpu.parallel.sharded import make_mesh
    solvers = _four_gpu_configs(make_mesh)
    np.savez(out_path, **{f"{name}_{f}": a for name, s in solvers.items()
                          for f, a in _first_tv(s).items()})


def four_gpu_phase():
    import jax
    from irs_mpc_tpu import IrsMpc, make_pendulum
    from irs_mpc_tpu.parallel.sharded import make_mesh
    import planar_hand

    check(len(jax.devices()) == 4, f"need 4 GPUs, have {jax.devices()}")
    solvers = _four_gpu_configs(make_mesh)
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = Path(tmp) / "cpu_ref.npz"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        subprocess.run([sys.executable, __file__, "--cpu-reference",
                        str(ref_path)], env=env, check=True, timeout=900)
        ref = dict(np.load(ref_path))
    singles = {
        "pendulum": IrsMpc(make_pendulum(0.05), pendulum_params("zero_order")),
        "planar_hand": planar_hand.build_solver()[0]}
    for name, solver in solvers.items():
        tv = _first_tv(solver)
        for f, a in tv.items():
            np.testing.assert_allclose(a, ref[f"{name}_{f}"], rtol=1e-3,
                                       atol=1e-4,
                                       err_msg=f"{name} {f}: 4 GPUs vs CPU")
        t0 = time.perf_counter()
        solver.iterate(3, verbose=False)
        wall = time.perf_counter() - t0
        single = singles[name]
        single.iterate(3, verbose=False)
        rel = abs(solver.cost - single.cost) / abs(single.cost)
        check(rel <= 0.12, f"{name}: 4-GPU cost {solver.cost} vs 1-GPU "
                           f"{single.cost} ({rel:.3f} > 0.12)")
        mesh = solver.params.mesh
        ms, _ = time_chained(iteration_step(solver, 1.0),
                             (solver.x_trj, solver.u_trj, solver.key), 5)
        emit("four_gpus", config=name, mesh=dict(mesh.shape),
             costs=solver.cost_lst, single_gpu_costs=single.cost_lst,
             final_rel_diff=rel, ms_per_iter=ms,
             iterate_wall_s_incl_compile=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU mesh-sharded path")
    ap.add_argument("--cpu-reference", metavar="NPZ", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "examples")]

    if args.cpu_reference:
        cpu_reference(args.cpu_reference)
        return

    device_phase()
    from irs_mpc_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import jax
    if args.four_gpus:
        four_gpu_phase()
    else:
        pendulum_phase()
        planar = planar_hand_phase()
        tv = phase_split(planar)
        kernel_phase(planar, tv)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
