"""Multi-device sharding tests on the virtual 8-device CPU mesh — the
single-host stand-in for a pod slice (SURVEY §4 implication 5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from irs_mpc_tpu import (IrsMpc, IrsMpcParams, SmoothingConfig,
                         estimate_tv_matrices, make_pendulum)
from irs_mpc_tpu.parallel.sharded import (default_mesh, make_mesh,
                                          sharded_estimate_tv_matrices)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _nominal(T=20):
    sys = make_pendulum(0.05)
    u_trj = jnp.ones((T, 1)) * 0.1
    x_trj = sys.rollout(jnp.zeros(2), u_trj)
    return sys, x_trj, u_trj


@pytest.mark.parametrize("mode", ["exact", "first_order", "zero_order",
                                  "zero_order_B", "zero_order_AB"])
def test_sharded_estimation_matches_single_device(mode):
    sys, x_trj, u_trj = _nominal()
    cfg = SmoothingConfig(num_samples=4000, std_x=0.3, std_u=0.3)
    mesh = make_mesh(4, 2)
    tv_s = sharded_estimate_tv_matrices(sys, mode, x_trj, u_trj,
                                        jax.random.PRNGKey(0), 1.0, cfg, mesh)
    tv_r = estimate_tv_matrices(sys, mode, x_trj, u_trj,
                                jax.random.PRNGKey(0), 1.0, cfg)
    # Statistically identical (different sample draws): tight for exact,
    # Monte-Carlo tolerance otherwise.
    tol = 1e-6 if mode == "exact" else 5e-2
    np.testing.assert_allclose(tv_s.A, tv_r.A, atol=tol)
    np.testing.assert_allclose(tv_s.B, tv_r.B, atol=tol)
    np.testing.assert_allclose(tv_s.c, tv_r.c, atol=tol)


def test_sharded_estimation_deterministic():
    sys, x_trj, u_trj = _nominal()
    cfg = SmoothingConfig(num_samples=800, std_x=0.3, std_u=0.3)
    mesh = make_mesh(8, 1)
    f = lambda: sharded_estimate_tv_matrices(
        sys, "zero_order", x_trj, u_trj, jax.random.PRNGKey(3), 1.0, cfg,
        mesh)
    np.testing.assert_array_equal(f().A, f().A)


def test_knot_padding():
    """T not divisible by knot shards must still give correct results."""
    sys, x_trj, u_trj = _nominal(T=13)
    cfg = SmoothingConfig(num_samples=800, std_x=0.3, std_u=0.3)
    mesh = make_mesh(4, 2)  # 13 % 2 != 0
    tv = sharded_estimate_tv_matrices(sys, "exact", x_trj, u_trj,
                                      jax.random.PRNGKey(0), 1.0, cfg, mesh)
    tv_r = estimate_tv_matrices(sys, "exact", x_trj, u_trj,
                                jax.random.PRNGKey(0), 1.0, cfg)
    np.testing.assert_allclose(tv.A, tv_r.A, atol=1e-6)
    assert tv.A.shape == (13, 2, 2)


def test_full_solver_on_mesh_converges():
    """End-to-end iRS-MPC with mesh-sharded estimation reproduces the
    single-device pendulum convergence."""
    T = 100
    mesh = default_mesh()
    params = IrsMpcParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([1.]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.tile([0.1], (T, 1)),
        gradient_mode="zero_order",
        smoothing=SmoothingConfig(num_samples=800, std_x=1.0, std_u=1.0),
        mesh=mesh)
    s = IrsMpc(make_pendulum(0.05), params)
    s.iterate(8, verbose=False)
    # Single-device run of the identical problem for comparison.
    params_single = dataclasses.replace(params, mesh=None)
    s_ref = IrsMpc(make_pendulum(0.05), params_single)
    s_ref.iterate(8, verbose=False)
    assert abs(s.cost - s_ref.cost) / s_ref.cost < 0.05


def test_multihost_helpers_single_process():
    from irs_mpc_tpu.parallel import multihost
    multihost.initialize()           # no-op on single process
    mesh = multihost.pod_mesh(knot_shards=2)
    assert dict(mesh.shape) == {"sample": 4, "knot": 2}
    assert multihost.is_coordinator()


def test_jax_distributed_two_process(tmp_path):
    """REAL multi-process execution of the pod path: two local CPU
    processes (2 virtual devices each) initialize ``jax.distributed``
    against a live coordinator, build the global (2, 2) ``pod_mesh``, and
    run one mesh-sharded zero-order estimation sweep whose psum crosses the
    process boundary.  Both processes must agree with each other AND with a
    single-process run of the same mesh shape — the estimator's keys and
    reductions depend only on mesh shape, not process layout.

    This is the first-class replacement for the reference's multi-process
    farm (``/root/reference/zmq_parallel_cmp/simple_task_vent.py:13-51``);
    see tests/distributed_child.py for the per-process program.
    """
    import os
    import socket
    import subprocess
    import sys as _sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    child = Path(__file__).resolve().parent / "distributed_child.py"
    out = tmp_path / "dist"
    procs = []
    # Children stay on the CPU: one JAX process per GPU, and this test
    # is about the process boundary, not the device.
    for pid in range(2):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   IRS_COORD_PORT=str(port), IRS_PROC_ID=str(pid),
                   IRS_NUM_PROCS="2", IRS_OUT=str(out))
        procs.append(subprocess.Popen(
            [_sys.executable, str(child)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(stdout)
    for p, stdout in zip(procs, outs):
        assert p.returncode == 0, f"child failed:\n{stdout}"

    import numpy as np
    r0 = np.load(f"{out}.0.npz")
    r1 = np.load(f"{out}.1.npz")
    assert int(r0["n_devices"]) == 4 and int(r0["n_local"]) == 2
    # Cross-process agreement (the allgathered global result is identical).
    np.testing.assert_array_equal(r0["A"], r1["A"])
    np.testing.assert_array_equal(r0["B"], r1["B"])
    np.testing.assert_array_equal(r0["c"], r1["c"])

    # Single-process ground truth on the same (2, 2) mesh shape.
    sys_, _, _ = _nominal()
    T = 12
    rng = np.random.RandomState(0)
    u_trj = jnp.asarray((0.5 * rng.randn(T, 1)).astype(np.float32))
    x_trj = sys_.rollout(jnp.zeros(2), u_trj)
    cfg = SmoothingConfig(num_samples=64, std_u=0.2, std_x=0.2)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    tv = sharded_estimate_tv_matrices(sys_, "zero_order", x_trj, u_trj,
                                      jax.random.PRNGKey(7), 1.0, cfg, mesh)
    np.testing.assert_allclose(r0["A"], tv.A, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(r0["B"], tv.B, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(r0["c"], tv.c, rtol=2e-5, atol=2e-5)


def test_sharded_contact_estimation():
    """Mesh-sharded estimation through the CONTACT engine (QP steps inside
    shard_map with psum moments)."""
    from irs_mpc_tpu.models.contact.systems import make_box_pushing
    from irs_mpc_tpu.ops.estimators import SmoothingConfig
    m = make_box_pushing()
    sys = m.system()
    x0 = jnp.asarray([0., 0.5, 0., 0., -0.12], jnp.float32)
    u_trj = jnp.tile(x0[3:5][None], (4, 1))
    x_trj = sys.rollout(x0, u_trj)
    cfg = SmoothingConfig(num_samples=64, std_x=1e-3, std_u=0.1,
                          decay=lambda it: 1.0, decay_std_x=False)
    mesh = make_mesh(4, 2)
    tv = sharded_estimate_tv_matrices(sys, "zero_order_B", x_trj, u_trj,
                                      jax.random.PRNGKey(0), 1.0, cfg, mesh)
    assert tv.B.shape == (4, 5, 2)
    assert bool(jnp.all(jnp.isfinite(tv.B)))
    # Hand command must move hand positions (B rows 3:5 ~ identity-ish).
    assert float(jnp.mean(jnp.abs(tv.B[:, 3:, :]))) > 0.2


def test_sharded_zero_order_B_first_order_A_source():
    """The sharded path honors zero_order_B_A_source="first_order" (the MBP
    reference's A-from-averaged-first-order semantics,
    mbp_dynamics.py:387-389), matching the single-device estimator.  Needs
    a system whose df/dx depends on u — control-affine mechanical systems
    (pendulum, bicycle) make the two A sources coincide — so uses a
    synthetic multiplicative-control system."""
    from irs_mpc_tpu.models.base import System
    h = 0.1

    def step(x, u):
        return x + h * jnp.tanh(x * u[0] + jnp.flip(x) * u[1])

    sys = System(name="mult_ctl", dim_x=3, dim_u=2, h=h, step=step)
    T = 20
    u_trj = jnp.tile(jnp.asarray([0.5, 0.2]), (T, 1))
    x_trj = sys.rollout(0.1 * jnp.arange(3, dtype=jnp.float32), u_trj)
    cfg = SmoothingConfig(num_samples=4000, std_x=0.3, std_u=0.5,
                          zero_order_B_A_source="first_order")
    mesh = make_mesh(4, 2)
    tv_s = sharded_estimate_tv_matrices(sys, "zero_order_B", x_trj, u_trj,
                                        jax.random.PRNGKey(0), 1.0, cfg, mesh)
    tv_r = estimate_tv_matrices(sys, "zero_order_B", x_trj, u_trj,
                                jax.random.PRNGKey(0), 1.0, cfg)
    np.testing.assert_allclose(tv_s.A, tv_r.A, atol=5e-2)
    np.testing.assert_allclose(tv_s.B, tv_r.B, atol=5e-2)
    # And it differs from the exact-A default (averaged-over-u-samples A
    # vs the Jacobian at the nominal).
    tv_exact_A = sharded_estimate_tv_matrices(
        sys, "zero_order_B", x_trj, u_trj, jax.random.PRNGKey(0), 1.0,
        SmoothingConfig(num_samples=4000, std_x=0.3, std_u=0.5), mesh)
    assert not np.allclose(tv_s.A, tv_exact_A.A, atol=1e-4)
