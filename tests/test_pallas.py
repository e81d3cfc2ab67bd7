"""The whole-loop boxed-ADMM GPU kernel (ops/pallas_admm.py, Pallas on the
Triton route) and the one place that chooses it (ops/admm.py).

On the CPU the kernel runs under the Pallas interpreter
(``solve_boxed_tvlqr_kernel(..., interpret=True)``) against the XLA sweep
loop, and its Triton lowering for CUDA is checked without a card.  The
compiled kernel itself runs only on a GPU: tests marked ``gpu`` do that
and skip here (``python -m pytest -m gpu tests/`` on the card).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from irs_mpc_tpu.ops import admm as admm_ops
from irs_mpc_tpu.ops import lqr
from irs_mpc_tpu.ops import pallas_admm


def _tracking(T, n, m, seed):
    rng = np.random.RandomState(seed)
    A = jnp.asarray(rng.randn(T, n, n) * 0.3 / np.sqrt(n) + np.eye(n),
                    jnp.float32)
    B = jnp.asarray(rng.randn(T, n, m) * 0.5, jnp.float32)
    c = jnp.asarray(rng.randn(T, n) * 0.1, jnp.float32)
    Q = jnp.asarray(np.diag(rng.rand(n) + 0.5), jnp.float32)
    R = jnp.asarray(np.diag(rng.rand(m) + 0.5), jnp.float32)
    x0 = jnp.asarray(rng.randn(n), jnp.float32)
    xd = jnp.asarray(rng.randn(T + 1, n) * 0.5, jnp.float32)
    return A, B, c, Q, R, x0, xd


def _problem(kinds, n_phys, m, T=4, seed=0):
    """(prob, bounds, n_phys, idx_w).  A du box needs the Δu-augmented
    layout (w = x[n_phys:]), exactly as the solver builds it."""
    A, B, c, Q, R, x0, xd = _tracking(T, n_phys, m, seed)
    if "du" in kinds:
        prob = lqr.build_delta_u_problem(A, B, c, Q, Q * 3, R, x0, xd,
                                         jnp.arange(m))
        idx_w = np.arange(n_phys, n_phys + m)
    else:
        prob = lqr.build_tracking_problem(A, B, c, Q, Q * 3, R, x0, xd)
        idx_w = None
    b = {}
    if "x" in kinds:
        b["x"] = jnp.stack([jnp.full((T + 1, n_phys), -1.0),
                            jnp.full((T + 1, n_phys), 1.0)])
    if "u" in kinds:
        b["u"] = jnp.stack([jnp.full((T, m), -0.3), jnp.full((T, m), 0.3)])
    if "dx" in kinds:
        b["dx"] = jnp.stack([jnp.full((T, n_phys), -0.5),
                             jnp.full((T, n_phys), 0.5)])
    if "du" in kinds:
        b["du"] = jnp.stack([jnp.full((T, m), -0.2), jnp.full((T, m), 0.2)])
    return prob, admm_ops.BoxBounds(**b), n_phys, idx_w


def _assert_kernel_matches_xla(prob, bounds, n_phys, idx_w, over_relax=1.6,
                               iters=3):
    """Tolerances as for any two f32 implementations of the same sweeps
    (u/x/K to 1e-3, residual to rtol 1e-2)."""
    kw = dict(n_phys=n_phys, idx_w=idx_w, rho=5.0, iters=iters,
              over_relax=over_relax)
    ref = admm_ops.solve_boxed_tvlqr(prob, bounds, kernel=False, **kw)
    ker = admm_ops.solve_boxed_tvlqr_kernel(prob, bounds, interpret=True,
                                            **kw)
    tol = dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ker.u_trj, ref.u_trj, **tol)
    np.testing.assert_allclose(ker.x_trj, ref.x_trj, **tol)
    np.testing.assert_allclose(ker.gains.K, ref.gains.K, **tol)
    np.testing.assert_allclose(ker.gains.k, ref.gains.k, **tol)
    np.testing.assert_allclose(ker.gains.P, ref.gains.P, rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(float(ker.r_primal), float(ref.r_primal),
                               rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(float(ker.r_dual), float(ref.r_dual),
                               rtol=1e-2, atol=1e-3)


_ALL_KIND_SETS = [ks for r in range(1, 5)
                  for ks in itertools.combinations(pallas_admm.KINDS, r)]


@pytest.mark.parametrize("kinds", _ALL_KIND_SETS,
                         ids=["+".join(k) for k in _ALL_KIND_SETS])
def test_kernel_matches_xla_every_bound_kind_set(kinds):
    """All 15 non-empty combinations of the reference's four bound kinds."""
    _assert_kernel_matches_xla(*_problem(kinds, n_phys=4, m=2, seed=13))


@pytest.mark.parametrize("n,m", [(2, 1), (2, 4), (7, 1), (7, 4), (11, 1),
                                 (11, 4), (16, 1), (16, 4)])
def test_kernel_matches_xla_padding_shapes(n, m):
    """State widths below, at and up to the 16-wide tile, inputs 1 and 4 —
    the padded rows/columns must decouple exactly."""
    _assert_kernel_matches_xla(*_problem(("x", "u"), n_phys=n, m=m,
                                         seed=n + m))


@pytest.mark.parametrize("over_relax", [1.0, 1.6, 1.9])
def test_kernel_matches_xla_over_relaxation(over_relax):
    _assert_kernel_matches_xla(*_problem(("u", "du"), n_phys=3, m=2,
                                         seed=7), over_relax=over_relax)


def test_kernel_lowers_to_triton_for_cuda():
    """The kernel at the planar-hand widths (T=30, n_aug=11, m=4, all four
    kinds, 12 sweeps) lowers to Triton IR for CUDA — every load and value a
    power-of-two tile, every primitive one the Triton route implements —
    without a card.  (Compiling the IR needs the GPU.)"""
    prob, bounds, n_phys, idx_w = _problem(("x", "u", "dx", "du"),
                                           n_phys=7, m=4, T=30)
    f = jax.jit(lambda p, b: admm_ops.solve_boxed_tvlqr_kernel(
        p, b, n_phys=n_phys, idx_w=idx_w, rho=1.0, iters=12,
        over_relax=1.6))
    text = f.trace(prob, bounds).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert 'name = "boxed_admm"' in text or "boxed_admm" in text


def test_kernel_values_stay_rank_two():
    """No value inside the kernel has rank > 2: Triton rewrites a rank-3
    broadcast-multiply-sum into a TF32 tensor-core dot, which cost the
    gains 1e-3 of relative accuracy on the H100."""
    prob, bounds, n_phys, idx_w = _problem(("x", "u", "dx", "du"),
                                           n_phys=7, m=4, T=5)
    jaxpr = jax.make_jaxpr(lambda p, b: admm_ops.solve_boxed_tvlqr_kernel(
        p, b, n_phys=n_phys, idx_w=idx_w, iters=2))(prob, bounds)
    calls = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert len(calls) == 1

    def ranks(jx):
        for eqn in jx.eqns:
            for v in eqn.outvars:
                if hasattr(v.aval, "shape") and not hasattr(v.aval, "inner_aval"):
                    yield len(v.aval.shape), eqn.primitive.name
            for sub in jax.core.jaxprs_in_params(eqn.params):
                yield from ranks(sub)

    bad = [r for r in ranks(calls[0].params["jaxpr"]) if r[0] > 2]
    assert not bad, bad[:5]


def test_padded_dims():
    assert pallas_admm.padded_dims(2, 1) == (16, 1)
    assert pallas_admm.padded_dims(11, 4) == (16, 4)
    assert pallas_admm.padded_dims(16, 3) == (16, 4)
    assert pallas_admm.padded_dims(17, 5) == (32, 8)


# ---- the one place that chooses -------------------------------------------

def _dispatch_case(kinds=("u",), n_phys=7, m=4):
    prob, bounds, n_phys, idx_w = _problem(kinds, n_phys=n_phys, m=m)
    T, n, m = prob.B.shape
    return bounds, n_phys, n, m, idx_w


@pytest.mark.parametrize("case,expect", [
    (dict(platform="gpu"), None),
    (dict(platform="cpu"), "only on a GPU"),
    (dict(platform="gpu", parallel=True), "associative"),
    (dict(platform="gpu", bounds=admm_ops.BoxBounds()), "no bound kind"),
    (dict(platform="gpu", n=17), "exceed"),
    (dict(platform="gpu", kinds=("du",)), None),
    (dict(platform="gpu", kinds=("du",), idx_w=np.arange(0, 4)),
     "arange(n_phys, n)"),
])
def test_kernel_unsupported_rule(case, expect):
    bounds, n_phys, n, m, idx_w = _dispatch_case(case.get("kinds", ("u",)))
    why = admm_ops.kernel_unsupported(
        case.get("bounds", bounds), n_phys, case.get("n", n), m,
        case.get("idx_w", idx_w), case.get("parallel", False),
        case["platform"])
    if expect is None:
        assert why is None
    else:
        assert expect in why


def test_traced_idx_w_takes_the_xla_path():
    bounds, n_phys, n, m, idx_w = _dispatch_case(("du",))
    seen = []

    @jax.jit
    def probe(w):
        seen.append(admm_ops.kernel_unsupported(bounds, n_phys, n, m, w,
                                                False, "gpu"))
        return w

    probe(jnp.asarray(idx_w))
    assert "traced idx_w" in seen[0]


def test_kernel_request_raises_where_it_cannot_run():
    """On the CPU there is no kernel: asking for it raises, and the default
    choice is the XLA path, bit for bit (nothing runs interpreted)."""
    prob, bounds, n_phys, idx_w = _problem(("u",), n_phys=3, m=2)
    kw = dict(n_phys=n_phys, idx_w=idx_w, rho=5.0, iters=3)
    with pytest.raises(ValueError, match="only on a GPU"):
        admm_ops.solve_boxed_tvlqr(prob, bounds, kernel=True, **kw)
    with pytest.raises(ValueError, match="no bound kind"):
        admm_ops.solve_boxed_tvlqr(prob, admm_ops.BoxBounds(), kernel=True,
                                   **kw)
    auto = admm_ops.solve_boxed_tvlqr(prob, bounds, **kw)
    xla = admm_ops.solve_boxed_tvlqr(prob, bounds, kernel=False, **kw)
    np.testing.assert_array_equal(np.asarray(auto.u_trj),
                                  np.asarray(xla.u_trj))


def test_solver_kernel_request_raises_on_cpu():
    """IrsMpcParams.admm_kernel=True reaches the chooser and raises off
    the GPU instead of running anything else."""
    from irs_mpc_tpu import IrsMpc, IrsMpcParams, SmoothingConfig
    from irs_mpc_tpu.models.pendulum import make_pendulum

    T = 5
    p = IrsMpcParams(
        Q=np.eye(2), Qd=np.eye(2), R=np.eye(1), x0=np.zeros(2),
        xd_trj=np.tile([np.pi, 0.], (T + 1, 1)),
        u_trj_init=np.zeros((T, 1)),
        u_bounds_abs=np.array([[-1.0], [1.0]]),
        gradient_mode="exact", admm_iters=2, admm_kernel=True,
        smoothing=SmoothingConfig(num_samples=4))
    s = IrsMpc(make_pendulum(0.05), p)
    with pytest.raises(ValueError, match="only on a GPU"):
        s.iterate(1, verbose=False)


# ---- on the card -----------------------------------------------------------

@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """The compiled kernel at the planar-hand widths against the XLA path
    under "highest" precision (chip_smoke.py runs the same comparison on
    the real captured problem)."""
    prob, bounds, n_phys, idx_w = _problem(("x", "u", "dx", "du"),
                                           n_phys=7, m=4, T=30)
    kw = dict(n_phys=n_phys, idx_w=idx_w, rho=1.0, iters=12,
              over_relax=1.6)
    with jax.default_matmul_precision("highest"):
        ker = admm_ops.solve_boxed_tvlqr(prob, bounds, kernel=True, **kw)
        ref = admm_ops.solve_boxed_tvlqr(prob, bounds, kernel=False, **kw)
    np.testing.assert_allclose(ker.u_trj, ref.u_trj, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ker.x_trj, ref.x_trj, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ker.gains.K, ref.gains.K, rtol=1e-3,
                               atol=1e-3)
