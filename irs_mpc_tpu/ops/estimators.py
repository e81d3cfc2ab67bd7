"""Smoothed time-varying linearization estimators.

The reference implements these twice — per-knot python loops inside optimizer
subclasses (``irs_lqr/irs_lqr_{exact,first_order,zero_order}.py``) and as
methods of the simulator-backed dynamics (``quasistatic_dynamics.py:190-300``),
farmed out over ZMQ worker processes.  Here each estimator is a single pure
function vmapped over (knots x samples): one jitted sweep computes every
``A_t, B_t, c_t`` in one device program.  Least-squares fits go through
normal-equation moments so that a multi-device sample shard reduces with one
``psum`` of small (p x p) / (p x n) matrices per knot (see parallel/).

Modes (names match the reference ``gradient_mode`` strings,
``quasistatic_dynamics.py:210-240``):
  * "exact"          — A,B from the exact Jacobian.
  * "first_order"    — average of Jacobians at perturbed points.
  * "zero_order"     — generic: sample (dx,du), fit [A|B] jointly
                       (``irs_lqr_zero_order.py:27-63``).
  * "zero_order_B"   — sample du only; B from lstsq, A from exact Jacobian
                       (``quasistatic_dynamics.py:242-266``).
  * "zero_order_AB"  — sample (dx,du), damped lstsq for both
                       (``quasistatic_dynamics.py:268-300``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import System
from .linalg import solve_spd

Array = jax.Array

GRADIENT_MODES = ("exact", "first_order", "zero_order", "zero_order_B",
                  "zero_order_AB")


class TvLinearization(NamedTuple):
    """Time-varying affine model x_{t+1} ≈ A_t x_t + B_t u_t + c_t."""
    A: Array  # (T, n, n)
    B: Array  # (T, n, m)
    c: Array  # (T, n)


@dataclasses.dataclass(frozen=True)
class SmoothingConfig:
    """Monte-Carlo smoothing configuration.

    ``std_x``/``std_u`` are base standard deviations; ``decay(iter)`` returns a
    multiplicative scale (the reference's variance-decay schedules, e.g.
    ``1/iter**0.5`` in ``pendulum_zero_order.py:38-43`` and
    ``1/iter**0.8`` in ``run_planar_hand.py:142-143``).
    """
    num_samples: int = 100
    std_x: float | Array = 1e-3
    std_u: float | Array = 0.1
    decay: Callable[[Array], Array] = lambda it: 1.0 / jnp.sqrt(it)
    damp: float = 1e-2          # Tikhonov damping for zero_order_AB
    decay_std_x: bool = True    # whether decay applies to std_x as well
    # A-matrix source for zero_order_B.  The quasistatic reference uses the
    # exact Jacobian at the nominal (quasistatic_dynamics.py:242-266); the
    # second-order MBP reference instead averages first-order Jacobians over
    # the same u-samples (mbp_dynamics.py:387-389).
    zero_order_B_A_source: str = "exact"    # "exact" | "first_order"

    def stds(self, it: Array, dim_x: int, dim_u: int):
        scale = self.decay(jnp.asarray(it, jnp.float32))
        sx = jnp.broadcast_to(jnp.asarray(self.std_x, jnp.float32), (dim_x,))
        su = jnp.broadcast_to(jnp.asarray(self.std_u, jnp.float32), (dim_u,))
        sx = sx * (scale if self.decay_std_x else 1.0)
        return sx, su * scale

    # Value-based hash/eq so that two textually identical configs (or a
    # ``dataclasses.replace`` copy) hit the same jit-cache entry instead of
    # silently retracing — a contact-system retrace costs minutes on a small
    # host.  ``decay`` is a callable and stays identity-keyed (there is no
    # sound value equality for closures), so only *rebuilding the lambda*
    # forces a retrace; all the numeric fields compare by value.
    def _value_key(self):
        def arr_key(v):
            a = np.asarray(v)
            return (a.shape, tuple(a.ravel().tolist()))
        return (self.num_samples, arr_key(self.std_x), arr_key(self.std_u),
                self.damp, self.decay_std_x, self.zero_order_B_A_source)

    def __hash__(self):
        return hash(self._value_key())

    def __eq__(self, other):
        if not isinstance(other, SmoothingConfig):
            return NotImplemented
        if self._value_key() != other._value_key():
            return False
        # Same underlying callable => equal; different callables compare
        # equal only if they share the code object and closure values (the
        # common "same lambda text rebuilt" case, e.g. module reload or
        # dataclasses.replace in a builder function).
        f, g = self.decay, other.decay
        if f is g:
            return True
        try:
            same_code = f.__code__ == g.__code__
            cf = tuple(c.cell_contents for c in (f.__closure__ or ()))
            cg = tuple(c.cell_contents for c in (g.__closure__ or ()))
            return same_code and cf == cg
        except Exception:
            return False


def _sample_perturbations(key, std_x, std_u, num_samples):
    kx, ku = jax.random.split(key)
    dx = std_x * jax.random.normal(kx, (num_samples, std_x.shape[0]))
    du = std_u * jax.random.normal(ku, (num_samples, std_u.shape[0]))
    return dx, du


def _fit_lstsq(S: Array, D: Array, damp: float = 0.0) -> Array:
    """Least squares fit D ≈ S @ Theta via normal equations.

    S: (B, p) regressors, D: (B, n) targets; returns Theta' of shape (n, p)
    (i.e. the [A|B] layout).  Damping adds damp^2 * I to the Gram matrix —
    equivalent to the reference's stacked Tikhonov rows ``damp * I``
    (``quasistatic_dynamics.py:292-296``).

    Using moments G = S'S, M = S'D keeps the cross-device reduction a psum of
    (p,p)+(p,n) tensors per knot.
    """
    p = S.shape[1]
    G = S.T @ S + (damp * damp) * jnp.eye(p, dtype=S.dtype)
    M = S.T @ D
    # Tiny ridge for rank-deficient unregularized fits (lstsq fallback).
    eps = 1e-9 * jnp.trace(G) / p + 1e-12
    theta = solve_spd(G + eps * jnp.eye(p, dtype=S.dtype), M)
    return theta.T


def fit_from_moments(G: Array, M: Array, damp: float = 0.0) -> Array:
    """Solve the normal equations from pre-reduced moments (psum-friendly)."""
    p = G.shape[0]
    Gd = G + (damp * damp) * jnp.eye(p, dtype=G.dtype)
    eps = 1e-9 * jnp.trace(Gd) / p + 1e-12
    return solve_spd(Gd + eps * jnp.eye(p, dtype=G.dtype), M).T


def _flat_call(fn, *args_ts):
    """Call a per-row batched operator on (T, S, ...) inputs as ONE flat
    (T*S)-row batch and restore the (T, S) leading dims on every output
    leaf (array, tuple, NamedTuple or any other pytree).  Rows are
    independent under vmap, so this is a pure layout transform."""
    T, S = args_ts[0].shape[:2]
    flat = lambda a: a.reshape((T * S,) + a.shape[2:])
    out = fn(*(flat(a) for a in args_ts))
    return jax.tree.map(lambda o: o.reshape((T, S) + o.shape[1:]), out)


# ---------------------------------------------------------------------------
# Per-knot estimators (vmapped over the time axis by estimate_tv_matrices)
# ---------------------------------------------------------------------------

def _estimate_flat(system: System, mode: str, x_trj, u_trj, key, it,
                   cfg: SmoothingConfig):
    """Generic estimation sweep over all knots as ONE flat batch.

    Semantics per mode (names and behavior match the reference's
    ``gradient_mode`` strings):
      * "exact": A,B from the exact Jacobian at the nominal.
      * "first_order": average of Jacobians at the perturbed points
        (``irs_lqr_first_order.py``; the MBP variant averages over
        u-samples, mbp_dynamics.py:387-389).
      * "zero_order": joint [A|B] fit from (dx, du) rollout deltas
        (``irs_lqr_zero_order.py:27-63``).
      * "zero_order_B": B from input-only sampling; A from the exact
        Jacobian at the nominal (quasistatic reference,
        quasistatic_dynamics.py:242-266) or from first-order Jacobian
        averaging over the same u-samples (MBP reference) per
        ``cfg.zero_order_B_A_source``.
      * "zero_order_AB": joint damped [A|B] fit
        (``quasistatic_dynamics.py:268-300``).

    Sampling is bitwise-identical to a per-knot formulation (one key split
    per knot, same draw shapes/order); the flattening is a pure layout
    transform (see ``_flat_call``).  Returns (AB (T,n,n+m),
    f_nom (T,n)).
    """
    T = u_trj.shape[0]
    n = system.dim_x
    x_nom = x_trj[:-1]
    f_nom = system.step_batch(x_nom, u_trj)

    if mode == "exact":
        AB = system.jacobian_xu_batch(x_nom, u_trj)
        return AB, f_nom

    sx, su = cfg.stds(it, system.dim_x, system.dim_u)
    keys = jax.random.split(key, T)
    dx, du = jax.vmap(
        lambda k: _sample_perturbations(k, sx, su, cfg.num_samples))(keys)
    # Projection applies only where the reference estimators use it
    # (first_order and the generic zero_order); zero_order_B samples share
    # the nominal state and zero_order_AB fits raw perturbations.
    if system.projection is not None and mode in ("first_order",
                                                  "zero_order"):
        xp, up = jax.vmap(system.projection)(x_nom, dx, u_trj, du)
    else:
        xp, up = x_nom[:, None] + dx, u_trj[:, None] + du

    if mode == "first_order":
        ABs = _flat_call(system.jacobian_xu_batch, xp, up)
        AB = jnp.mean(ABs, axis=1)
    elif mode == "zero_order":
        if system.projection is not None:
            dx, du = xp - x_nom[:, None], up - u_trj[:, None]
        fd = _flat_call(system.step_batch, xp, up)
        S = jnp.concatenate([dx, du], axis=2)
        AB = jax.vmap(_fit_lstsq)(S, fd - f_nom[:, None])
    elif mode == "zero_order_B":
        # Samples share the nominal state (input-only sampling).
        xb = jnp.broadcast_to(x_nom[:, None], dx.shape)
        ub = u_trj[:, None] + du
        fd = _flat_call(system.step_batch, xb, ub)
        B_hat = jax.vmap(_fit_lstsq)(du, fd - f_nom[:, None])
        if cfg.zero_order_B_A_source == "first_order":
            ABj = _flat_call(system.jacobian_xu_batch, xb, ub)
            A_hat = jnp.mean(ABj, axis=1)[:, :, :n]
        else:
            A_hat = system.jacobian_xu_batch(x_nom, u_trj)[:, :, :n]
        AB = jnp.concatenate([A_hat, B_hat], axis=2)
    else:                                             # zero_order_AB
        fd = _flat_call(system.step_batch, xp, up)
        S = jnp.concatenate([dx, du], axis=2)
        AB = jax.vmap(lambda Si, Di: _fit_lstsq(Si, Di, damp=cfg.damp))(
            S, fd - f_nom[:, None])
    return AB, f_nom


def _estimate_fused(system: System, mode: str, x_trj, u_trj, key, it,
                    cfg: SmoothingConfig, need_A: bool):
    """Zero-order estimation through the system's fused sweep hook.

    One ``est_sweep_fn`` call computes the nominal steps at full solver
    accuracy AND all perturbed sample steps; the per-knot least-squares
    fits then run on the returned deltas.  Returns (tv, f_nom) — f_nom at
    full accuracy, reusable by ``decouple_AB``.

    Sampling is bitwise-identical to the per-knot path (same key splits,
    same draw shapes/order).  ``need_A=False`` (zero_order_B only) skips
    the exact-Jacobian A entirely — the caller is about to overwrite it
    (``decouple_AB``), and the Jacobian's implicit-function solve is the
    single most expensive node of the sweep.
    """
    dx, du = draw_perturbations(system, x_trj, u_trj, key, it, cfg)
    dx_arg = None if mode == "zero_order_B" else dx
    f_nom, fd = system.est_sweep_fn(x_trj[:-1], u_trj, dx_arg, du)
    return fit_sweep(system, mode, x_trj, u_trj, dx, du, f_nom, fd, cfg,
                     need_A)


def draw_perturbations(system: System, x_trj, u_trj, key, it,
                       cfg: SmoothingConfig):
    """The fused sweep's (T, S, n) / (T, S, m) sample perturbations: one
    key split per knot, the same draws as the per-knot path."""
    sx, su = cfg.stds(it, system.dim_x, system.dim_u)
    keys = jax.random.split(key, u_trj.shape[0])
    return jax.vmap(
        lambda k: _sample_perturbations(k, sx, su, cfg.num_samples))(keys)


def fit_sweep(system: System, mode: str, x_trj, u_trj, dx, du, f_nom, fd,
              cfg: SmoothingConfig, need_A: bool = True):
    """The per-knot least-squares fits of a fused sweep's outputs
    (``est_sweep_fn`` -> ``f_nom``, ``fd``).  Returns (tv, f_nom)."""
    T = u_trj.shape[0]
    n = system.dim_x
    D = fd - f_nom[:, None, :]                        # (T, S, n)

    if mode == "zero_order":
        S = jnp.concatenate([dx, du], axis=2)
        AB = jax.vmap(_fit_lstsq)(S, D)
    elif mode == "zero_order_AB":
        AB = jax.vmap(lambda Si, Di: _fit_lstsq(Si, Di, damp=cfg.damp))(
            jnp.concatenate([dx, du], axis=2), D)
    else:                                             # zero_order_B
        B_hat = jax.vmap(_fit_lstsq)(du, D)
        if need_A:
            if cfg.zero_order_B_A_source == "first_order":
                xp = jnp.broadcast_to(x_trj[:-1, None], dx.shape)
                ABj = _flat_call(system.jacobian_xu_batch,
                                 xp, u_trj[:, None] + du)
                A_hat = jnp.mean(ABj, axis=1)[:, :, :n]
            else:
                A_hat = system.jacobian_xu_batch(x_trj[:-1], u_trj)[:, :, :n]
        else:
            A_hat = jnp.zeros((T, n, n), D.dtype)
        AB = jnp.concatenate([A_hat, B_hat], axis=2)

    A, B = AB[:, :, :n], AB[:, :, n:]
    c = f_nom - jnp.einsum("tij,tj->ti", A, x_trj[:-1]) \
        - jnp.einsum("tij,tj->ti", B, u_trj)
    return TvLinearization(A=A, B=B, c=c), f_nom


def estimate_tv_matrices_fnom(
        system: System,
        mode: str,
        x_trj: Array,          # (T+1, n) nominal states
        u_trj: Array,          # (T, m) nominal inputs
        key: Array,
        it: Array,             # iteration count (drives variance decay)
        cfg: SmoothingConfig,
        need_A: bool = True):
    """Estimate (A_t, B_t, c_t); returns ``(tv, f_nom_or_None)``.

    ``f_nom`` is non-None only on the fused-hook path, where it is computed
    at full solver accuracy and may be reused downstream (decouple_AB).
    ``need_A=False`` is honored only where A is separately estimated and
    about to be discarded (zero_order_B via the hook).
    """
    if mode not in GRADIENT_MODES:
        raise ValueError(
            f"gradient mode {mode!r} not in {list(GRADIENT_MODES)}")
    if (system.est_sweep_fn is not None and system.projection is None
            and mode in ("zero_order", "zero_order_B", "zero_order_AB")):
        return _estimate_fused(system, mode, x_trj, u_trj, key, it, cfg,
                               need_A)
    n = system.dim_x
    AB, f_nom = _estimate_flat(system, mode, x_trj, u_trj, key, it, cfg)
    A, B = AB[:, :, :n], AB[:, :, n:]
    c = f_nom - jnp.einsum("tij,tj->ti", A, x_trj[:-1]) \
        - jnp.einsum("tij,tj->ti", B, u_trj)
    return TvLinearization(A=A, B=B, c=c), None


def estimate_tv_matrices(
        system: System,
        mode: str,
        x_trj: Array,
        u_trj: Array,
        key: Array,
        it: Array,
        cfg: SmoothingConfig) -> TvLinearization:
    """Estimate (A_t, B_t, c_t) for every knot in one vmapped sweep."""
    tv, _ = estimate_tv_matrices_fnom(system, mode, x_trj, u_trj, key, it,
                                      cfg)
    return tv


def decouple_AB(tv: TvLinearization, indices_u_into_x: Array,
                x_trj: Array, u_trj: Array,
                system: System, f_nom: Array | None = None
                ) -> TvLinearization:
    """Reference's ``decouple_AB_matrices`` (irs_lqr_quasistatic.py:275-284):
    overwrite A_t with I minus the actuated columns, and pin the actuated rows
    of B_t to the identity; c is re-derived for consistency.

    ``f_nom`` optionally supplies precomputed full-accuracy nominal steps
    (the fused estimation hook already solved them), avoiding a redundant
    batched re-step of the true system."""
    T, n, m = tv.B.shape
    A = jnp.broadcast_to(jnp.eye(n, dtype=tv.A.dtype), (T, n, n))
    A = A.at[:, :, indices_u_into_x].set(0.0)
    B = tv.B.at[:, indices_u_into_x, :].set(
        jnp.broadcast_to(jnp.eye(m, dtype=tv.B.dtype), (T, m, m)))
    if f_nom is None:
        f_nom = system.step_batch(x_trj[:-1], u_trj)
    c = f_nom - jnp.einsum("tij,tj->ti", A, x_trj[:-1]) \
        - jnp.einsum("tij,tj->ti", B, u_trj)
    return TvLinearization(A=A, B=B, c=c)
