"""Dynamical-system abstraction for the iRS-MPC framework.

The reference (``/root/reference/irs_lqr/dynamical_system.py:12-66``) defines a
virtual class with four methods (``dynamics``, ``dynamics_batch``,
``jacobian_xu``, ``jacobian_xu_batch``) that every backend re-implements by
hand (numpy loops, Drake symbolic Jacobians, torch, C++ sims).

Here a system is a single pure JAX step function; batching and Jacobians are
*derived* via ``jax.vmap`` / ``jax.jacfwd``, so every system is automatically
batched, differentiable, shardable, and jittable.  This collapses the
reference's L1 layer plus its per-system symbolic/AutoDiff machinery
(e.g. ``examples/pendulum/pendulum_dynamics.py:20-26,110-117``) into ~50 lines.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

Array = jax.Array
StepFn = Callable[[Array, Array], Array]
# Sample-projection operator: (x, dx, u, du) -> (x_proj, u_proj), used by
# systems with hard state constraints (reference:
# examples/three_cart/three_cart_dynamics.py:196-264).
ProjectionFn = Callable[[Array, Array, Array, Array], tuple[Array, Array]]


@dataclasses.dataclass(frozen=True)
class System:
    """A discrete-time dynamical system ``x_{t+1} = step(x_t, u_t)``.

    Mirrors the capability surface of the reference ``DynamicalSystem``
    (``irs_lqr/dynamical_system.py``): timestep ``h``, dims, dynamics, batched
    dynamics and fat Jacobian ``[df/dx | df/du]`` — but all derived from the
    single pure ``step``.
    """

    name: str
    dim_x: int
    dim_u: int
    h: float
    step: StepFn
    # Optional projection of samples onto a constraint manifold.
    projection: Optional[ProjectionFn] = None
    # Optional warm-started step for serial rollout chains:
    # (x, u, carry) -> (x_next, carry).  A system whose step is itself an
    # iterative solve (contact QPs) can warm-start each knot from the
    # previous knot's solution — trajectories change slowly, so a warm
    # solve converges in ~1/3 the cold iterations.  Must agree with
    # ``step`` to solver tolerance.  ``ws_init_fn()`` builds the initial
    # carry (static shapes).  The warm path is NOT differentiable; it is
    # used for rollouts only — Jacobians always go through ``step``.
    step_ws_fn: Optional[Callable[[Array, Array, object],
                                  tuple[Array, object]]] = None
    ws_init_fn: Optional[Callable[[], object]] = None
    # Optional fused Monte-Carlo estimation sweep for solver-backed systems
    # (ops/estimators.py uses it for the zero-order modes):
    #   est_sweep_fn(x_nom (T,n), u_nom (T,m), dx (T,S,n)|None, du (T,S,m))
    #     -> (f_nom (T,n), fd (T,S,n))
    # computing the nominal steps at FULL solver accuracy plus the perturbed
    # sample steps in one batched pass.  ``dx=None`` declares that samples
    # share the nominal state (zero_order_B), letting a contact system
    # assemble constraints once per knot instead of once per sample.
    # f_nom must be at least as accurate as vmap(step) so callers may reuse
    # it for the affine drift c and decouple_AB's re-derivation.
    est_sweep_fn: Optional[Callable] = None

    # ---- derived operators (all jit/vmap/shard compatible) -------------

    def step_batch(self, x: Array, u: Array) -> Array:
        """Batched dynamics: (B,n),(B,m) -> (B,n)."""
        return jax.vmap(self.step)(x, u)

    def jacobian_xu(self, x: Array, u: Array) -> Array:
        """Fat Jacobian ``[df/dx | df/du]`` of shape (n, n+m)."""
        jx, ju = jax.jacfwd(self.step, argnums=(0, 1))(x, u)
        return jnp.concatenate([jx, ju], axis=1)

    def jacobian_xu_batch(self, x: Array, u: Array) -> Array:
        """Batched fat Jacobian: (B,n),(B,m) -> (B,n,n+m)."""
        return jax.vmap(self.jacobian_xu)(x, u)

    def rollout(self, x0: Array, u_trj: Array) -> Array:
        """Open-loop rollout; returns the (T+1, n) state trajectory.

        Replaces the reference's python rollout loop
        (``irs_lqr/irs_lqr.py:105-119``) with a ``lax.scan``.  Uses the
        warm-started step chain when the system provides one (the serial
        rollout is the latency wall for contact systems).
        """
        if self.step_ws_fn is not None:
            def body_ws(carry, u):
                x, ws = carry
                x_next, ws = self.step_ws_fn(x, u, ws)
                return (x_next, ws), x_next

            _, xs = jax.lax.scan(body_ws, (x0, self.ws_init_fn()), u_trj)
            return jnp.concatenate([x0[None], xs], axis=0)

        def body(x, u):
            x_next = self.step(x, u)
            return x_next, x_next

        _, xs = jax.lax.scan(body, x0, u_trj)
        return jnp.concatenate([x0[None], xs], axis=0)

    def rollout_batch(self, x0: Array, u_trj_b: Array) -> Array:
        """Population rollout: (n,), (B, T, m) -> (B, T+1, n), one
        (warm-chained, where the system has one) rollout per candidate."""
        return jax.vmap(lambda u: self.rollout(x0, u))(u_trj_b)

    def __hash__(self):  # static closure key for jit caching
        return hash((self.name, self.dim_x, self.dim_u, self.h, id(self.step)))

    def __eq__(self, other):
        return self is other
