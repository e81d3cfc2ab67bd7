"""Benchmark suite: one JSON line per metric, headline metric LAST.

Every line names the device it ran on; a run that finds no GPU, or a GPU
missing from the peaks table, fails instead of measuring something else.
Any failed section makes the process exit nonzero (the other sections
still run and print).

Metrics:

1. planar_hand_irs_iterations_per_s — full jitted iRS-MPC iterations/s on
   the contact-rich planar hand (examples/planar_hand.py: 50 samples x 30
   knots of Monte-Carlo contact estimation + decoupled fit + boxed-ADMM
   trajectory QP + line-searched forward rollout of the true contact
   dynamics), against the measured one-CPU-core denominator
   (BASELINE_CPU.json from bench_baseline_cpu.py).
2. planar_hand_contact_rollouts_per_s — smoothed contact sample steps/s
   inside those same iterations (T x num_samples per iteration).
3. planar_hand_second_iterations_per_s — the second-order (mbp2d)
   planar-hand iteration with first-order-A estimation.
4. contact_qp_saturation_peak_qps / pendulum_rollout_saturation_peak_per_s
   — throughput-vs-batch sweeps (vmapped XLA PDIP; pendulum rollouts) with
   per-point GFLOP/s and roofline share, and the knee batch.
5. smoothed_rollouts_per_s — pendulum zero-order smoothing, T=200, 1000
   samples/knot, full iteration.

Timing: one method.  ``_timeit`` chains calls and syncs the device once per
block (as a descent does), median over blocks.  On an H100 a host sync
costs about 0.1 ms more than a chained dispatch of the same tiny program,
so blocks are long enough that the sync is a small share of each block.

Defining benchmark cells and their metrics is left to the benchmark PR;
this file keeps the suite runnable and honest on the GPU.
"""
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def device_fields():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def emit(metric, value, unit, vs_baseline, **extra):
    line = {"metric": metric, "value": float(value), "unit": unit,
            "vs_baseline": float(vs_baseline), "device": device_fields()}
    line.update(extra)
    print(json.dumps(line), flush=True)


N_BLOCKS = 5  # median-of-N timing blocks per metric


def _timeit(fn, n_reps, n_blocks=N_BLOCKS):
    """Median-of-``n_blocks`` time per call; each block chains ``n_reps``
    calls and syncs once.  Returns (median, min, max) over blocks so every
    emitted metric carries its own run-to-run spread."""
    import jax
    jax.block_until_ready(fn())      # compile
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n_blocks):
        t0 = time.perf_counter()
        for _ in range(n_reps):
            out = fn()
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / n_reps)
    ts.sort()
    return ts[len(ts) // 2], ts[0], ts[-1]


def spread_fields(dt_med, dt_min, dt_max, to_value):
    """Value-space spread fields for a time-per-call triple.  ``to_value``
    maps a dt to the metric's value (throughputs invert, so min/max swap)."""
    vals = sorted([to_value(dt_min), to_value(dt_max)])
    return dict(value_min=float(vals[0]), value_max=float(vals[1]),
                n_blocks=N_BLOCKS)


# ---------------------------------------------------------------------------
# Roofline accounting
#
# The shapes of every hot loop are static, so the FLOP and minimum-memory-
# byte counts per iteration are analytic functions of (T, n, m, samples,
# qp_iters).  The workload forces full-f32 products
# (default_matmul_precision("highest")), so the compute ceiling is the
# card's float32 rate outside the tensor cores, not its TF32 or bf16 rate.
# ---------------------------------------------------------------------------

# Published dense peaks by JAX device_kind, at the card's full power limit
# (NVIDIA H100 data sheet, SXM part).  A card set below its limit cannot
# hold these clocks; the limit is printed beside every run.  A device
# missing from this table is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        f32=67e12, tf32=495e12, bf16=989e12, hbm_bytes_per_s=3.35e12,
        source="NVIDIA H100 SXM data sheet (dense, no sparsity)"),
}


def peaks(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {device_kind!r}; add it to "
            f"bench.PEAKS with its source") from None


def roofline_fields(flops, hbm_bytes, dt, transcendentals=0):
    """Achieved GFLOP/s, share of the f32 peak, arithmetic intensity, and a
    latency/bandwidth/compute-bound verdict for a measured time.

    ``hbm_bytes`` is the MINIMUM traffic model: each major intermediate
    written once + read once (XLA fusion can only approach this from above),
    so the bandwidth-bound time is a lower bound and 'latency-bound' is a
    conservative verdict."""
    import jax
    pk = peaks(jax.devices()[0].device_kind)
    t_compute = flops / pk["f32"]
    t_bw = hbm_bytes / pk["hbm_bytes_per_s"]
    if dt > 3.0 * max(t_compute, t_bw):
        bound = "latency"
    elif t_bw > t_compute:
        bound = "bandwidth"
    else:
        bound = "compute"
    return dict(
        flops_per_iter=int(flops),
        hbm_bytes_per_iter=int(hbm_bytes),
        achieved_gflops=flops / dt / 1e9,
        f32_peak_share=flops / dt / pk["f32"],
        roofline_share=max(t_compute, t_bw) / dt,
        arithmetic_intensity=flops / max(hbm_bytes, 1),
        roofline_bound=bound,
        roofline_t_compute_us=t_compute * 1e6,
        roofline_t_bandwidth_us=t_bw * 1e6,
        transcendentals_per_iter=int(transcendentals),
    )


def _pdip_iter_flops(n, mr):
    """One PDIP iteration on an (n-var, mr-row) QP (qp._pdip_solve body):
    residuals (P@x, C@x, C'lam ~ 2n^2 + 4 mr n), H = P + (C' w) C
    (2 mr n^2), unrolled Gauss-Jordan solve (~2/3 n^3 + 2 n^2, counted as
    n^3 + 2n^2 for the full-row elimination actually traced), back-subs and
    step-size logic (~10 mr + 6 n)."""
    return (2 * n * n + 4 * mr * n) + 2 * mr * n * n + (
        n ** 3 + 2 * n * n) + 10 * mr + 6 * n


def pendulum_roofline(T, S, dt):
    """Analytic per-iteration counts for the pendulum zero-order bench.

    Dominant phases: Monte-Carlo sampling (T*S normal draws over p = n+m
    dims), the smoothed rollout (T*S pendulum steps, ~12 flops + 1 sin
    each), the per-knot normal-equation moments (S'S (p,p) + S'D (p,n):
    2*S*(p^2 + p*n) flops per knot), tiny p^3 fits + (2,1)-sized Riccati,
    and the 6-alpha line-search rollout."""
    n, m = 2, 1
    p = n + m
    step = 12
    flops = (
        T * S * (p * 8)                      # Box-Muller-class RNG math
        + T * S * step                       # smoothed rollout
        + T * 2 * S * (p * p + p * n)        # moments
        + T * (p ** 3 + 40)                  # fit + Riccati
        + 6 * T * (step + 4 * n * n)         # line-search feedback rollouts
    )
    transcendentals = T * S * 2 + 6 * T      # sin per step; logs in RNG ~2/draw
    hbm = 4 * (
        2 * T * S * p                        # samples written + read
        + 2 * T * S * n                      # rollout outputs
        + 4 * T * p * p                      # moments + fits
        + 8 * T * n                          # trajectories, gains, plans
    )
    return roofline_fields(flops, hbm, dt, transcendentals)


def planar_hand_roofline(model, T, S, n_alpha, dt):
    """Analytic per-iteration counts for the planar-hand contact bench.

    Phases: (1) fused estimation — ONE full-accuracy nominal solve per
    knot (qp_iters=30) + T*S sample QPs through the PDIP surrogate
    (qp_iters=15); geometry runs once per KNOT (zero_order_B samples share
    the nominal state, so constraint rows are broadcast); (2) the boxed-
    ADMM trajectory QP (aug n=11: one factorization + 12 affine sweeps);
    (3) the serial true-dynamics forward rollout — T knots x n_alpha
    line-search lanes x 10 warm-started PDIP iterations."""
    nq = model.nq
    mr = model.n_constraint_rows()
    geom = 60 * mr + 40 * nq                 # narrow phase + row assembly
    est_iters = 15                           # estimation_surrogate default
    est = (T * (geom + model.qp_iters * _pdip_iter_flops(nq, mr))
           + T * S * est_iters * _pdip_iter_flops(nq, mr))

    n_aug, m = nq + 4, 4
    sweeps = 12
    fact = T * (6 * n_aug ** 3 + n_aug * m * m * 2)
    sweep = sweeps * T * (6 * n_aug * n_aug + 4 * n_aug * m)
    admm = fact + sweep

    ws_iters = 10
    rollout = n_alpha * T * (geom + ws_iters * _pdip_iter_flops(nq, mr))

    flops = est + admm + rollout
    transcendentals = (T * S + n_alpha * T) * 30   # trig in arm kinematics
    hbm = 4 * (
        3 * T * S * (nq * nq + mr * nq + nq + mr)  # QP data + solutions
        + 2 * T * (n_aug * n_aug * 3)              # A/B/Q + gains
        + 6 * T * n_alpha * nq                     # line-search trajectories
    )
    f = roofline_fields(flops, hbm, dt, transcendentals)
    f.update(flops_estimation=int(est), flops_admm=int(admm),
             flops_forward_rollout=int(rollout))
    return f


def build_planar_hand_solver():
    """The examples/planar_hand.py configuration (reference
    run_planar_hand.py task)."""
    sys.path.insert(0, str(ROOT / "examples"))
    import planar_hand
    solver, model = planar_hand.build_solver()
    return solver, model, solver.T, solver.params.smoothing.num_samples


def _cpu_baseline():
    """Measured single-core CPU denominator (bench_baseline_cpu.py writes
    BASELINE_CPU.json)."""
    with open(ROOT / "BASELINE_CPU.json") as f:
        data = json.load(f)
    return dict(baseline_iters_per_s=data["iters_per_s"],
                baseline_source="this framework on one XLA CPU core "
                "(BASELINE_CPU.json, taskset -c 0)",
                baseline_cpu1core_ms_per_iter=data["ms_per_iter"])


def _chained_step(solver, it):
    import jax.numpy as jnp
    it = jnp.asarray(it, jnp.float32)
    state = [solver.x_trj, solver.u_trj, solver.key]

    def step():
        x, u, key, out = solver._iteration_jit(state[0], state[1], state[2],
                                               it)
        state[0], state[1], state[2] = x, u, key
        return out[0]
    return step


def bench_planar_hand():
    """Full-iteration contact-engine throughput."""
    solver, model, T, num_samples = build_planar_hand_solver()
    dt, dt_lo, dt_hi = _timeit(_chained_step(solver, 2.0), 20)
    iters_per_s = 1.0 / dt
    base = _cpu_baseline()
    n_alpha = len(solver.params.line_search_alphas)
    roof = planar_hand_roofline(model, T, num_samples, n_alpha, dt)
    emit("planar_hand_irs_iterations_per_s", iters_per_s,
         "iterations/s (50 samples x 30 knots, PDIP estimation + "
         "boxed-ADMM QP + contact forward rollout)",
         iters_per_s / base["baseline_iters_per_s"],
         ms_per_iter=dt * 1e3, **base, **roof,
         **spread_fields(dt, dt_lo, dt_hi, lambda t: 1.0 / t))
    rollouts = T * num_samples / dt
    emit("planar_hand_contact_rollouts_per_s", rollouts,
         "contact sample steps/s", rollouts / 10_000.0,
         **spread_fields(dt, dt_lo, dt_hi,
                         lambda t: T * num_samples / t))


def bench_pendulum():
    """Pendulum zero-order smoothing, T=200, 1000 samples/knot."""
    from irs_mpc_tpu import IrsMpc, IrsMpcParams, SmoothingConfig, \
        make_pendulum

    T = 200
    num_samples = 1000  # matches pendulum_zero_order.py:33
    params = IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2),
        xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)),
        gradient_mode="zero_order",
        smoothing=SmoothingConfig(num_samples=num_samples, std_x=1.0,
                                  std_u=1.0),
    )
    solver = IrsMpc(make_pendulum(0.05), params)
    dt, dt_lo, dt_hi = _timeit(_chained_step(solver, 1.0), 50)
    value = T * num_samples / dt
    roof = pendulum_roofline(T, num_samples, dt)
    emit("smoothed_rollouts_per_s", value, "sample steps/s",
         value / 10_000.0, ms_per_iter=dt * 1e3, **roof,
         **spread_fields(dt, dt_lo, dt_hi,
                         lambda t: T * num_samples / t))


def _sweep_point(batch, dt, flops_per_item, key):
    import jax
    pk = peaks(jax.devices()[0].device_kind)
    gflops = batch * flops_per_item / dt / 1e9
    return {"batch": batch, key: batch / dt, "us_per_call": dt * 1e6,
            "achieved_gflops": gflops,
            "f32_peak_share": gflops * 1e9 / pk["f32"]}


def bench_saturation():
    """Throughput-vs-batch saturation sweeps: where does the card stop
    being latency-bound and start being fed?

    Two workloads: (a) planar-hand contact QPs through the vmapped XLA PDIP
    (the estimation sweep's inner op), (b) pendulum smoothed rollout steps
    (the zero-order sweep's inner op).  Emits per-point achieved GFLOP/s
    and f32-peak share, and the knee batch (smallest batch reaching 70% of
    peak throughput)."""
    import jax
    import jax.numpy as jnp
    from irs_mpc_tpu import make_pendulum
    from irs_mpc_tpu.models.contact.qp import solve_qp
    from irs_mpc_tpu.models.contact.systems import make_planar_hand

    # --- (a) contact QPs ---------------------------------------------------
    model = make_planar_hand(h=0.1)
    nq, mr = model.nq, model.n_constraint_rows()
    iters = 15
    flops_per_qp = iters * _pdip_iter_flops(nq, mr)
    key = jax.random.PRNGKey(0)
    q_nom = jnp.asarray(model.get_x_from_q_dict(
        {"sphere": np.array([0.0, 0.35, 0.0]),
         "arm_left": np.array([-np.pi / 4, -np.pi / 4]),
         "arm_right": np.array([np.pi / 4, np.pi / 4])}))
    iu = model.indices_u_into_x()
    B_max = 1 << 18
    ku, kx = jax.random.split(key)
    xs_all = q_nom[None] + 1e-3 * jax.random.normal(kx, (B_max, nq))
    us_all = (q_nom[iu][None]
              + 0.3 * jax.random.normal(ku, (B_max, model.dim_u)))
    P_all, b_all = jax.jit(jax.vmap(model._hessian_and_bias))(xs_all, us_all)
    C_all, d_all = jax.jit(jax.vmap(model._constraint_rows))(xs_all)
    jax.block_until_ready(d_all)
    pdip = jax.jit(jax.vmap(lambda P, b, C, d: solve_qp(P, b, C, d, iters)))

    sweep_qp = []
    for log2b in range(8, 19, 2):
        B = 1 << log2b
        args = (P_all[:B], b_all[:B], C_all[:B], d_all[:B])
        dt, _, _ = _timeit(lambda: pdip(*args), 5, n_blocks=3)
        sweep_qp.append(_sweep_point(B, dt, flops_per_qp, "qps_per_s"))
    peak = max(p["qps_per_s"] for p in sweep_qp)
    knee = next(p["batch"] for p in sweep_qp
                if p["qps_per_s"] >= 0.7 * peak)
    peak_point = max(sweep_qp, key=lambda p: p["achieved_gflops"])
    emit("contact_qp_saturation_peak_qps", peak,
         "QPs/s (planar-hand PDIP-15, vmapped XLA, batch sweep 2^8..2^18)",
         peak / (1500.0 / 2.5e-3), knee_batch=knee,
         peak_gflops=peak_point["achieved_gflops"],
         peak_f32_share=peak_point["f32_peak_share"], sweep=sweep_qp)

    # --- (b) pendulum rollout steps ---------------------------------------
    pend = make_pendulum(0.05)
    T = 200
    flops_per_rollout = T * 12
    sweep_ro = []
    for log2b in range(8, 17, 2):
        S = 1 << log2b
        k1, k2 = jax.random.split(jax.random.PRNGKey(log2b))
        x0 = jax.random.normal(k1, (S, 2))
        u_seq = 0.3 * jax.random.normal(k2, (T, S, 1))

        def roll(x0=x0, u_seq=u_seq):
            def body(x, u):
                xn = jax.vmap(pend.step)(x, u)
                return xn, jnp.sum(xn, axis=1)
            _, out = jax.lax.scan(body, x0, u_seq)
            return out

        fn = jax.jit(roll)
        dt, _, _ = _timeit(fn, 5, n_blocks=3)
        sweep_ro.append(_sweep_point(S, dt, flops_per_rollout,
                                     "rollouts_per_s"))
    peak_ro = max(p["rollouts_per_s"] for p in sweep_ro)
    knee_ro = next(p["batch"] for p in sweep_ro
                   if p["rollouts_per_s"] >= 0.7 * peak_ro)
    peak_point_ro = max(sweep_ro, key=lambda p: p["achieved_gflops"])
    emit("pendulum_rollout_saturation_peak_per_s", peak_ro,
         "full T=200 rollouts/s (batch sweep 2^8..2^16)",
         peak_ro / 10_000.0, knee_batch=knee_ro,
         peak_gflops=peak_point_ro["achieved_gflops"],
         peak_f32_share=peak_point_ro["f32_peak_share"], sweep=sweep_ro)


def bench_second_order():
    """Second-order (MBP-equivalent) planar-hand iteration throughput.
    Reference analogue: the IrsLqrMbpPosition farm over Drake AutoDiff sim
    steps (/root/reference/irs_lqr/mbp_dynamics.py:268-323, 387-434).  The
    estimation sweep runs as one flat (T*S)-row batch (ops/estimators.py);
    the forward rollout reuses the warm-chain machinery (step_ws)."""
    sys.path.insert(0, str(ROOT / "examples"))
    from planar_hand_second_order import build_solver

    solver, mbp = build_solver(control_mode="position", num_samples=50,
                               T=30)
    dt, dt_lo, dt_hi = _timeit(_chained_step(solver, 2.0), 10)
    iters_per_s = 1.0 / dt

    # Phase flops: T*S velocity-QP solves (nv-dim, mr rows, 30 iters) for
    # B + the same again with 14-tangent JVPs for the first-order A (each
    # tangent ~ one KKT backsolve), + n_alpha*T warm rollout steps.
    T, S, n_alpha = 30, 50, len(solver.params.line_search_alphas)
    base = mbp.base
    nv, mr = base.nq, base.n_constraint_rows()
    n_x = 2 * nv
    qp_fl = base.qp_iters * _pdip_iter_flops(nv, mr)
    jvp_fl = n_x * (2 * nv * nv + nv ** 3 // 3)
    est = T * S * (qp_fl + qp_fl + jvp_fl)
    n_aug = n_x + 4
    admm = 30 * T * (6 * n_aug * n_aug + 4 * n_aug * 4) + T * 6 * n_aug ** 3
    rollout = n_alpha * T * (base.qp_iters_ws * _pdip_iter_flops(nv, mr))
    flops = est + admm + rollout
    hbm = 4 * (3 * T * S * (nv * nv + mr * nv) + 8 * T * n_aug * n_aug)
    f = roofline_fields(flops, hbm, dt, transcendentals=T * S * 30)
    f.update(flops_estimation=int(est), flops_admm=int(admm),
             flops_forward_rollout=int(rollout))
    emit("planar_hand_second_iterations_per_s", iters_per_s,
         "iterations/s (second-order mbp2d position mode, 50 samples x "
         "30 knots, first-order-A zero_order_B estimation)",
         iters_per_s / _cpu_baseline()["baseline_iters_per_s"],
         ms_per_iter=dt * 1e3, **f,
         **spread_fields(dt, dt_lo, dt_hi, lambda t: 1.0 / t))


def main():
    import jax
    from irs_mpc_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found "
                 f"{jax.default_backend()!r}")
    peaks(jax.devices()[0].device_kind)
    failed = []
    for fn in (bench_planar_hand, bench_second_order, bench_saturation,
               bench_pendulum):
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(fn.__name__)
    if failed:
        sys.exit(f"bench.py: failed sections {failed}")


if __name__ == "__main__":
    main()
