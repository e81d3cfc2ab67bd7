"""Scaling-efficiency benchmark: estimation throughput vs mesh size.

Supplemental to bench.py (BASELINE.md north star: >=80% scaling efficiency
to N devices).  Measures the mesh-sharded estimation sweep (the reference's
only distributed phase — its ZMQ farm's role, ``irs_lqr_quasistatic.py:
228-273``) three ways:

* STRONG scaling — fixed global sample count, devices 1, 2, 4, ...;
  efficiency = t(1) / (t(s) * s).
* WEAK scaling — fixed per-device sample count (global grows with the
  mesh); efficiency = t(1) / t(s) (ideal: flat).
* PER-PHASE breakdown — the sweep is one fused XLA program, so phases are
  isolated by timing structurally-identical sub-programs: the ``psum``
  collective of the per-knot regression moments alone (same shapes and
  mesh as the real reduction), and the per-knot least-squares fit alone.
  ``compute`` is reported as the remainder.  On virtual CPU devices the
  collective column is the only number that generalizes to hardware —
  virtual devices share physical cores, so "scaling" of the compute phase
  there only measures how under-saturated the 1-device run was.

Run with ``--cpu`` (8 virtual CPU devices) to exercise the SPMD path
without GPUs; on a multi-GPU host it measures true efficiency.
``--two-proc`` times a mesh whose sample axis spans two CPU processes.
"""
import json
import os
import sys
import time

import numpy as np

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")


def _time(f, *args, reps=20):
    import jax
    out = f(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def projected_pod_budget(n, m, T, sweep_s):
    """Projected multi-host communication budget for the estimation sweep.

    The ONLY cross-device traffic per sweep is the moment psum: per knot a
    (p, p) Gram and a (p, n) cross-moment in f32 (parallel/sharded.py).  A
    ring all-reduce moves ~2x the payload per chip, so with the knot axis
    local the per-GPU bytes are 2 * T * (p^2 + p*n) * 4.  Projected at
    H100 SXM NVLink (450 GB/s each way, data sheet) within a host and a
    400 Gb/s InfiniBand port (50 GB/s) per GPU across hosts — stated
    assumptions, not measurements — this gives the collective seconds a
    multi-host run must beat for the >= 80% scaling north star."""
    NVLINK_BPS = 450e9
    NETWORK_BPS = 50e9
    p = n + m
    payload = T * (p * p + p * n) * 4
    ring = 2 * payload
    t_nvl = ring / NVLINK_BPS
    t_net = ring / NETWORK_BPS
    return {
        "psum_payload_bytes_per_sweep": int(payload),
        "ring_bytes_per_gpu_per_sweep": int(ring),
        "projected_collective_s_nvlink": t_nvl,
        "projected_collective_s_network": t_net,
        "projected_collective_frac_nvlink": t_nvl / sweep_s,
        "projected_collective_frac_network": t_net / sweep_s,
        "assumed_nvlink_Bps": NVLINK_BPS, "assumed_network_Bps": NETWORK_BPS,
        "note": ("projected multi-host efficiency = 1/(1 + frac): the "
                 "moment tensors are the only cross-host traffic, so the "
                 ">=80% north star holds whenever frac <= 0.25"),
    }


def measure_sweep(mesh, system, cfg, T=64, reps=20):
    """Full estimation sweep seconds/iteration on the given mesh."""
    import jax
    import jax.numpy as jnp
    from irs_mpc_tpu.parallel.sharded import sharded_estimate_tv_matrices

    u_trj = jnp.ones((T, system.dim_u)) * 0.1
    x_trj = system.rollout(jnp.zeros(system.dim_x), u_trj)
    key = jax.random.PRNGKey(0)
    f = jax.jit(lambda k: sharded_estimate_tv_matrices(
        system, "zero_order", x_trj, u_trj, k, 1.0, cfg, mesh))
    return _time(f, key, reps=reps)


def measure_collective(mesh, n, m, T=64, reps=50):
    """The moment-psum alone: same tensor shapes, mesh, and axis as the real
    reduction inside ``sharded_estimate_tv_matrices`` (G (p,p), M (p,n) per
    local knot), nothing else."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    p = n + m
    n_knot = mesh.shape["knot"]
    T_local = (T + n_knot - 1) // n_knot

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("knot"), P("knot")), out_specs=P("knot"))
    def reduce_moments(G, M):
        return (jax.lax.psum(G, "sample"),
                jax.lax.psum(M, "sample"))

    G = jnp.ones((T_local * n_knot, p, p), jnp.float32)
    M = jnp.ones((T_local * n_knot, p, n), jnp.float32)
    return _time(lambda: reduce_moments(G, M), reps=reps)


def measure_fit(n, m, T=64, reps=50):
    """The per-knot least-squares fit alone (replicated: every device does
    all T fits in the real sweep's tail)."""
    import jax
    import jax.numpy as jnp
    from irs_mpc_tpu.ops.estimators import fit_from_moments

    p = n + m
    rng = np.random.RandomState(0)
    S = rng.randn(T, 256, p).astype(np.float32)
    G = jnp.einsum("tsp,tsq->tpq", S, S)
    M = jnp.asarray(rng.randn(T, p, n), jnp.float32)
    f = jax.jit(jax.vmap(fit_from_moments))
    return _time(lambda: f(G, M), reps=reps)


def _dist_child_main():
    """Per-process program for the ``--two-proc`` bench (and its 1-process
    control).  Mirrors tests/distributed_child.py but measures TIME: the
    full mesh-sharded estimation sweep and the moment-psum alone, on a mesh
    whose sample axis spans the process boundary — so the psum executes the
    real cross-process collective path (the reference's multi-process farm
    role, ``zmq_parallel_cmp/simple_task_vent.py:13-51``)."""
    import json as _json
    from functools import partial

    pid = int(os.environ.get("IRS_PROC_ID", "0"))
    nproc = int(os.environ.get("IRS_NUM_PROCS", "1"))
    devs_per_proc = int(os.environ.get("IRS_DEVS_PER_PROC", "4"))
    out_path = os.environ["IRS_OUT"]
    reps = int(os.environ.get("IRS_BENCH_REPS", "10"))

    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append(f"--xla_force_host_platform_device_count={devs_per_proc}")
    os.environ["XLA_FLAGS"] = " ".join(flags)

    import jax
    jax.config.update("jax_platforms", "cpu")

    from irs_mpc_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    from irs_mpc_tpu.parallel import multihost
    if nproc > 1:
        port = os.environ["IRS_COORD_PORT"]
        multihost.initialize(coordinator_address=f"localhost:{port}",
                             num_processes=nproc, process_id=pid)
        assert jax.process_count() == nproc

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from irs_mpc_tpu import SmoothingConfig, make_pendulum
    from irs_mpc_tpu.parallel.sharded import sharded_estimate_tv_matrices

    # (sample = all devices, knot = 1): the moment psum reduces over the
    # sample axis, which spans BOTH processes in the 2-proc run.
    mesh = multihost.pod_mesh(knot_shards=1)
    rep = NamedSharding(mesh, P())

    def gput(a):
        a = np.asarray(a)
        return jax.make_array_from_callback(a.shape, rep, lambda i: a[i])

    system = make_pendulum(0.05)
    T = 16
    u_trj = gput(np.full((T, 1), 0.1, np.float32))
    x_trj = gput(np.asarray(system.rollout(
        jnp.zeros(2), jnp.full((T, 1), 0.1, jnp.float32))))
    key = gput(np.asarray(jax.random.PRNGKey(0)))
    it = gput(np.float32(1.0))
    cfg = SmoothingConfig(num_samples=512, std_x=1.0, std_u=1.0)

    fn = jax.jit(lambda x, u, k, i: sharded_estimate_tv_matrices(
        system, "zero_order", x, u, k, i, cfg, mesh))
    sweep_s = _time(lambda: fn(x_trj, u_trj, key, it).B, reps=reps)

    # The psum alone, same shapes/axis as the sweep's real reduction.
    n, m = system.dim_x, system.dim_u
    p = n + m

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("knot"), P("knot")), out_specs=P("knot"))
    def reduce_moments(G, M):
        return jax.lax.psum(G, "sample"), jax.lax.psum(M, "sample")

    G = gput(np.ones((T, p, p), np.float32))
    M = gput(np.ones((T, p, n), np.float32))
    coll_s = _time(lambda: reduce_moments(G, M), reps=5 * reps)

    with open(f"{out_path}.{pid}.json", "w") as f:
        _json.dump({"pid": pid, "nproc": nproc,
                    "n_local": len(jax.local_devices()),
                    "n_devices": len(jax.devices()),
                    "sweep_s": sweep_s, "coll_s": coll_s}, f)
    print(f"proc {pid}/{nproc}: sweep {sweep_s*1e3:.2f} ms "
          f"coll {coll_s*1e3:.3f} ms", flush=True)


def two_proc_main():
    """Spawn the 2-process bench + its 1-process 4-device control and emit
    one JSON line.  This times the only path virtual single-process meshes
    cannot: collectives that cross a process boundary (gloo on the CPU;
    NCCL over NVLink or the network on GPUs).  The children stay on the
    CPU: one JAX process per GPU."""
    import json as _json
    import socket
    import subprocess
    import tempfile
    from pathlib import Path

    here = Path(__file__).resolve().parent
    tmp = tempfile.mkdtemp(prefix="irs_2proc_")

    def spawn(pid, nproc, devs, port, tag):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   IRS_PROC_ID=str(pid), IRS_NUM_PROCS=str(nproc),
                   IRS_DEVS_PER_PROC=str(devs),
                   IRS_OUT=f"{tmp}/{tag}", IRS_BENCH_REPS="10")
        if nproc > 1:
            env["IRS_COORD_PORT"] = str(port)
        return subprocess.Popen(
            [sys.executable, str(here / "bench_scaling.py"), "--dist-child"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    # 1-process control: same global mesh shape (4 devices), no processes.
    solo = spawn(0, 1, 4, None, "solo")
    out, _ = solo.communicate(timeout=1200)
    assert solo.returncode == 0, f"solo child failed:\n{out}"
    solo_r = _json.load(open(f"{tmp}/solo.0.json"))

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [spawn(pid, 2, 2, port, "pod") for pid in range(2)]
    outs = []
    for pr in procs:
        try:
            o, _ = pr.communicate(timeout=1200)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(o)
    for pr, o in zip(procs, outs):
        assert pr.returncode == 0, f"pod child failed:\n{o}"
    rs = [_json.load(open(f"{tmp}/pod.{pid}.json")) for pid in range(2)]

    sweep = max(r["sweep_s"] for r in rs)
    coll = max(r["coll_s"] for r in rs)
    artifact = {
        "metric": "two_process_pod_estimation_sweep",
        "platform": "cpu(gloo)", "processes": 2,
        "devices_per_process": 2, "mesh": {"sample": 4, "knot": 1},
        "samples": 512, "T": 16,
        "sweep_s_per_iter": round(sweep, 5),
        "collective_s": round(coll, 6),
        "collective_frac": round(coll / sweep, 4),
        "single_process_same_mesh_s": round(solo_r["sweep_s"], 5),
        "single_process_collective_s": round(solo_r["coll_s"], 6),
        "cross_process_overhead": round(sweep / solo_r["sweep_s"], 3),
        "projected_pod_budget": projected_pod_budget(2, 1, 16, sweep),
        "caveat": ("2 local CPU processes over gloo on shared cores: the "
                   "collective crosses a REAL process boundary (the path "
                   "virtual meshes cannot test) but its latency is loopback "
                   "gloo, not NVLink or InfiniBand; compare collective_frac, not "
                   "absolute seconds"),
    }
    print(json.dumps(artifact))


def main():
    import jax
    from irs_mpc_tpu import SmoothingConfig, make_pendulum
    from irs_mpc_tpu.parallel.sharded import make_mesh
    from irs_mpc_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    n_dev = len(jax.devices())
    system = make_pendulum(0.05)
    n, m = system.dim_x, system.dim_u
    sizes = [s for s in (1, 2, 4, 8, 16) if s <= n_dev]

    GLOBAL_SAMPLES = 1 << 14          # strong-scaling problem size
    PER_DEVICE_SAMPLES = 1 << 12      # weak-scaling per-device size

    fit_t = measure_fit(n, m)
    strong, weak = {}, {}
    for s in sizes:
        mesh = make_mesh(s, 1, jax.devices()[:s])
        coll_t = measure_collective(mesh, n, m)
        cfg_s = SmoothingConfig(num_samples=GLOBAL_SAMPLES,
                                std_x=1.0, std_u=1.0)
        t_s = measure_sweep(mesh, system, cfg_s)
        strong[s] = {"total": t_s, "collective": coll_t, "fit": fit_t,
                     "compute": max(0.0, t_s - coll_t - fit_t)}
        cfg_w = SmoothingConfig(num_samples=PER_DEVICE_SAMPLES * s,
                                std_x=1.0, std_u=1.0)
        t_w = measure_sweep(mesh, system, cfg_w)
        weak[s] = {"total": t_w, "collective": coll_t, "fit": fit_t,
                   "compute": max(0.0, t_w - coll_t - fit_t)}

    def table(res, weak_mode):
        base = res[sizes[0]]["total"]
        out = {}
        for s in sizes:
            r = res[s]
            eff = (base / r["total"] if weak_mode
                   else base / r["total"] / s)
            out[str(s)] = {
                "seconds_per_sweep": round(r["total"], 5),
                "collective_s": round(r["collective"], 6),
                "fit_s": round(r["fit"], 6),
                "compute_s": round(r["compute"], 5),
                "collective_frac": round(r["collective"] / r["total"], 4),
                "efficiency": round(eff, 3),
            }
        return out

    out = {"metric": "estimation_sweep_scaling",
           "devices": n_dev, "platform": jax.default_backend(),
           "strong": {"global_samples": GLOBAL_SAMPLES,
                      "results": table(strong, weak_mode=False)},
           "weak": {"per_device_samples": PER_DEVICE_SAMPLES,
                    "results": table(weak, weak_mode=True)},
           "projected_pod_budget": projected_pod_budget(
               n, m, 64, strong[sizes[-1]]["total"])}
    if jax.default_backend() == "cpu":
        out["caveat"] = (
            "virtual CPU devices share physical cores: compute-phase "
            "scaling here only measures how under-saturated the 1-device "
            "run was; the collective column (the real SPMD overhead) is "
            "the honest hardware-relevant signal")
    print(json.dumps(out))


if __name__ == "__main__":
    if "--dist-child" in sys.argv:
        _dist_child_main()
    elif "--two-proc" in sys.argv:
        two_proc_main()
    else:
        main()
