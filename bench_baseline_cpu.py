"""Measure the planar-hand contact-iteration baseline on the CPU backend.

The reference never records wall-clock for its 18-process CPU farm, so
since r3 the bench's ``vs_baseline`` used an ESTIMATED 2 iterations/s
denominator (flagged ``baseline_estimated``).  This script replaces the
guess with a measurement: the IDENTICAL planar-hand sweep (50 samples x
30 knots, same budgets, same solver configuration as
``bench.build_planar_hand_solver``) run on the XLA CPU backend pinned to
ONE core (``taskset -c 0``), i.e. the per-worker throughput of a
reference-style farm built from this framework's own math.  An 18-worker
farm extrapolation (the reference's planar-hand worker count,
``/root/reference/examples/planar_hand/planar_hand_setup.py:33``) is
recorded alongside as the generous upper bound.

Writes BASELINE_CPU.json; bench.py picks it up and drops
``baseline_estimated`` to false.

Run:  taskset -c 0 python bench_baseline_cpu.py
"""
import json
import os
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_cpu_multi_thread_eigen=false"
    + " intra_op_parallelism_threads=1"
)
os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    import jax.numpy as jnp

    from bench import build_planar_hand_solver

    assert jax.default_backend() == "cpu"
    solver, model, T, num_samples = build_planar_hand_solver()
    it = jnp.asarray(2.0, jnp.float32)
    state = [solver.x_trj, solver.u_trj, solver.key]

    def step():
        x, u, key, out = solver._iteration_jit(state[0], state[1],
                                               state[2], it)
        state[0], state[1], state[2] = x, u, key
        return out[0]

    jax.block_until_ready(step())          # compile
    jax.block_until_ready(step())
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(3):
            out = step()
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / 3)
    ts.sort()
    dt = ts[len(ts) // 2]
    result = {
        "metric": "planar_hand_irs_iterations_per_s_cpu1core",
        "iters_per_s": round(1.0 / dt, 4),
        "ms_per_iter": round(dt * 1e3, 3),
        "ms_min": round(ts[0] * 1e3, 3),
        "ms_max": round(ts[-1] * 1e3, 3),
        "n_blocks": 5,
        "backend": "cpu (XLA, 1 core via taskset; "
                   "multi_thread_eigen=false)",
        "workload": f"{num_samples} samples x {T} knots, identical "
                    f"solver config to bench.py",
        "farm18_extrapolated_iters_per_s": round(18.0 / dt, 4),
        "note": "farm18 assumes perfect 18-worker scaling of the "
                "estimation sweep AND free trajectory-QP/rollout phases "
                "- a deliberately generous reference-farm upper bound",
    }
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BASELINE_CPU.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
