"""CEM baseline tests (reference: cem.py drivers, e.g. quadrotor_cem.py)."""
import jax.numpy as jnp
import numpy as np

from irs_mpc_tpu import make_pendulum
from irs_mpc_tpu.solvers.cem import CemParams, CrossEntropyMethod


def test_cem_pendulum_descends():
    T = 60
    p = CemParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([0.1]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.zeros((T, 1)),
        n_elite=20, batch_size=300, initial_std=np.array([1.0]))
    cem = CrossEntropyMethod(make_pendulum(0.05), p)
    c0 = cem.cost
    cem.iterate(15, verbose=False)
    assert cem.cost_best < 0.5 * c0
    assert len(cem.cost_lst) == 16
    assert cem.cost_best == min(cem.cost_lst)


def test_cem_adaptive_std_shrinks():
    T = 30
    p = CemParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([0.1]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.zeros((T, 1)),
        n_elite=10, batch_size=100, initial_std=np.array([1.0]))
    cem = CrossEntropyMethod(make_pendulum(0.05), p)
    s0 = float(jnp.mean(cem.std_trj))
    cem.iterate(10, verbose=False)
    assert float(jnp.mean(cem.std_trj)) < s0


def test_cem_respects_u_bounds():
    T = 30
    p = CemParams(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([0.1]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.zeros((T, 1)),
        n_elite=10, batch_size=100, initial_std=np.array([1.0]),
        u_bounds_abs=np.array([[-0.7], [0.7]]))
    cem = CrossEntropyMethod(make_pendulum(0.05), p)
    cem.iterate(5, verbose=False)
    assert np.all(np.abs(cem.u_trj_lst[-1]) <= 0.7 + 1e-6)


def test_cem_contact_delta_u():
    """CEM against the quasistatic contact engine with Δu cost
    (CrossEntropyMethodQuasistatic analogue)."""
    import sys as _s
    from pathlib import Path
    _s.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    from planar_hand_cem import build_solver
    cem, model = build_solver(T=15, batch_size=50, n_elite=8)
    c0 = cem.cost
    cem.iterate(5, verbose=False)
    assert cem.cost_best < c0
    assert np.all(np.isfinite(cem.u_trj_lst[-1]))


def _pendulum_params(T=30, **kw):
    base = dict(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([0.1]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.zeros((T, 1)),
        n_elite=10, batch_size=100, initial_std=np.array([1.0]))
    base.update(kw)
    return CemParams(**base)


def test_cem_param_validation():
    import pytest
    for bad in [dict(momentum=1.0), dict(momentum=-0.1),
                dict(noise_beta=1.0), dict(noise_beta=-0.2),
                dict(elite_keep=11), dict(elite_keep=-1)]:
        with pytest.raises(ValueError):
            CrossEntropyMethod(make_pendulum(0.05), _pendulum_params(**bad))


def test_cem_std_floor_holds():
    floor = np.array([0.35])
    cem = CrossEntropyMethod(make_pendulum(0.05),
                             _pendulum_params(std_floor=floor))
    cem.iterate(10, verbose=False)
    assert float(jnp.min(cem.std_trj)) >= 0.35 - 1e-6


def test_cem_momentum_damps_refit():
    """With refit smoothing a, the one-step mean update is exactly (1-a)
    times the vanilla update under the same PRNG seed."""
    cem0 = CrossEntropyMethod(make_pendulum(0.05), _pendulum_params(seed=3))
    cem1 = CrossEntropyMethod(make_pendulum(0.05),
                              _pendulum_params(seed=3, momentum=0.8))
    u0 = np.asarray(cem0.u_trj)
    cem0.iterate(1, verbose=False)
    cem1.iterate(1, verbose=False)
    d0 = np.asarray(cem0.u_trj) - u0
    d1 = np.asarray(cem1.u_trj) - u0
    np.testing.assert_allclose(d1, 0.2 * d0, rtol=1e-4, atol=1e-6)


def test_cem_ar1_noise_keeps_unit_marginal_variance():
    """AR(1)-correlated noise must not change the per-knot sampling std:
    refitting on the WHOLE population (n_elite = batch) recovers std ~ 1 at
    every knot, correlated or not."""
    T = 40
    stds = []
    for beta in (0.0, 0.9):
        cem = CrossEntropyMethod(make_pendulum(0.05), _pendulum_params(
            T=T, batch_size=3000, n_elite=3000, noise_beta=beta, seed=5))
        cem.iterate(1, verbose=False)
        stds.append(np.asarray(cem.std_trj))
    for s in stds:
        np.testing.assert_allclose(s, np.ones_like(s), rtol=0.08)


def test_cem_elite_keep_preserves_best():
    """Persisted elites make the population's best cost monotone: the best
    candidate of iteration k is re-injected verbatim into iteration k+1, so
    cost_lst of the running best never regresses past it."""
    cem = CrossEntropyMethod(make_pendulum(0.05), _pendulum_params(
        elite_keep=5, batch_size=80, n_elite=10, seed=1))
    cem.iterate(8, verbose=False)
    assert cem.kept.shape == (5, 30, 1)
    assert np.all(np.isfinite(cem.cost_lst))
    # The nominal is seeded into population 1 (kept starts as copies of it),
    # so iteration 1's best candidate can be no worse than the initial cost.
    assert cem.cost_lst[1] <= cem.cost_lst[0] + 1e-5


def test_cem_divergent_mean_rollout_rejected():
    """If the elites' mean rollout blows up, the refit is rejected: cost
    history stays finite and the previous mean is kept (regression for the
    all-NaN quadrotor_cem curve)."""
    from irs_mpc_tpu.models.base import System

    def step(x, u):
        # Explosive beyond |x| > 2: overflows to inf/nan within a few steps.
        return jnp.where(jnp.abs(x) > 2.0, x * x * 1e10, x + 0.1 * u)

    sys_ = System(name="explosive", dim_x=1, dim_u=1, h=0.1, step=step)
    T = 20
    cem = CrossEntropyMethod(sys_, CemParams(
        Q=np.eye(1), Qd=np.eye(1), R=np.eye(1) * 1e-3,
        x0=np.zeros(1), xd_trj=np.tile([1.9], (T + 1, 1)),
        u_trj_init=np.zeros((T, 1)),
        n_elite=5, batch_size=50, initial_std=np.array([5.0]), seed=0))
    cem.iterate(8, verbose=False)
    assert np.all(np.isfinite(cem.cost_lst)), cem.cost_lst
    assert np.isfinite(cem.cost_best)


def test_cem_noise_knots_band_limited():
    """noise_knots: interpolation weights are unit-marginal-variance, the
    knob validates its range, and a band-limited search still solves the
    swing-up (reference has no such knob; this is the repo's iCEM-class
    extension for long-horizon plants)."""
    import pytest

    T = 60
    base = dict(
        Q=np.diag([1., 1.]), Qd=np.diag([20., 20.]), R=np.diag([0.1]),
        x0=np.zeros(2), xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.zeros((T, 1)),
        n_elite=20, batch_size=300, initial_std=np.array([1.0]))
    cem = CrossEntropyMethod(make_pendulum(0.05),
                             CemParams(**base, noise_knots=10))
    # Rows of the interpolation matrix are unit-norm (std_trj keeps meaning)
    # and every row touches at most 2 adjacent knots (linear interp).
    W = np.asarray(cem._knot_W)
    assert W.shape == (T, 10)
    np.testing.assert_allclose((W ** 2).sum(axis=1), 1.0, rtol=1e-5)
    assert int((W != 0).sum(axis=1).max()) <= 2
    c0 = cem.cost
    cem.iterate(15, verbose=False)
    assert cem.cost_best < 0.5 * c0

    for bad in (-1, 1, T + 1):
        with pytest.raises(ValueError):
            CrossEntropyMethod(make_pendulum(0.05),
                               CemParams(**base, noise_knots=bad))


def test_rollout_batch_matches_vmapped_rollout():
    """System.rollout_batch is the population rollout CEM-style callers
    use: one warm-chained rollout per candidate, identical to vmapping
    ``rollout`` by hand."""
    import jax

    from irs_mpc_tpu.models.contact.systems import make_box_pushing

    m = make_box_pushing()
    sys_ref = m.system()
    rng = np.random.RandomState(0)
    B, T = 6, 5
    x0 = jnp.asarray([0., 0.5, 0., 0., -0.12], jnp.float32)
    u_b = jnp.asarray(
        np.tile(np.asarray(x0)[m.indices_u_into_x()], (B, T, 1))
        + rng.randn(B, T, 2) * 0.02, jnp.float32)
    xs_fb = sys_ref.rollout_batch(x0, u_b)
    xs_vm = jax.vmap(lambda u: sys_ref.rollout(x0, u))(u_b)
    assert xs_fb.shape == (B, T + 1, m.nq)
    np.testing.assert_allclose(xs_fb, xs_vm, atol=0)
