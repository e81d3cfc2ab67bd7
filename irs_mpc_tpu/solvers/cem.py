"""Cross-entropy method baseline, fully vectorized on-device.

Capability parity with the reference's ``CrossEntropyMethod``
(``/root/reference/irs_lqr/cem.py:34-216``) and its quasistatic/MBP variants
(``cem_quasistatic.py``, ``cem_mbp*.py``): Gaussian population over entire
input trajectories, elite selection, mean/std refit with adaptive variance.
The reference rolls out the population serially in python (``cem.py:166-169``,
its hot loop); here the whole population rolls as one ``vmap`` over a
``lax.scan`` — B x T dynamics steps in a single XLA program — and elites come
from ``lax.top_k``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import System

Array = jax.Array


@dataclasses.dataclass
class CemParams:
    """Mirrors ``CemParameters`` (cem.py:7-32)."""
    Q: np.ndarray = None
    Qd: np.ndarray = None
    R: np.ndarray = None
    x0: np.ndarray = None
    xd_trj: np.ndarray = None
    u_trj_init: np.ndarray = None
    n_elite: int = 20
    batch_size: int = 200
    initial_std: np.ndarray = None       # (m,) per-input std
    # Δu-cost mode (quasistatic CEM variants, cem_quasistatic.py:147-153).
    indices_u_into_x: Optional[np.ndarray] = None
    # Optional clipping box on sampled inputs (2, m).
    u_bounds_abs: Optional[np.ndarray] = None
    seed: int = 0
    # Reference quirk: evaluate_cost uses Q (not Qd) on the final state.
    report_final_cost_with_Q: bool = True

    # ---- search upgrades (all default-off: vanilla reference CEM) ----
    # On-device populations are nearly free, but vanilla CEM still wastes the
    # budget on long horizons: per-knot white noise almost never produces a
    # coherent 200-knot maneuver, and the elite refit collapses std before
    # the search finds one.  These four knobs are the standard fixes
    # (cf. iCEM, Pinneri et al. 2020 — public algorithm; re-implemented):
    #
    # Elementwise floor on the refit std (scalar or (m,)): prevents
    # premature variance collapse on multimodal landscapes.
    std_floor: Optional[np.ndarray] = None
    # Refit smoothing a in [0, 1): new = (1 - a) * refit + a * previous,
    # applied to both mean and std.  Damps elite-noise-driven jitter.
    momentum: float = 0.0
    # AR(1) temporal correlation of the sampled noise along the horizon:
    # eps_t = beta * eps_{t-1} + sqrt(1 - beta^2) * w_t.  beta ~ 0.7-0.9
    # concentrates the search on low-frequency input variations — the ones
    # that actually move a trajectory — while keeping Var[eps_t] = 1.
    noise_beta: float = 0.0
    # Re-inject the previous iteration's top-k elites into the candidate
    # population so the best known trajectories survive resampling.
    elite_keep: int = 0
    # Band-limited exploration: sample the noise at K control knots spread
    # over the horizon and linearly interpolate to all T knots (0 = off).
    # Unlike AR(1) low-passing (noise_beta), interpolated noise has ZERO
    # high-frequency content — on stiff long-horizon plants (quadrotor RPY
    # over 200 steps) it is the per-knot jitter, not the correlation length,
    # that destabilizes rollouts, so this explores coherent low-frequency
    # maneuvers at stds AR(1) cannot tolerate.  Marginal variance is
    # renormalized to 1 so std_trj keeps its meaning.
    noise_knots: int = 0


class CrossEntropyMethod:
    """construct with (system, params); ``iterate(n) -> (x_trj, u_trj, cost)``
    with history lists, like the reference."""

    def __init__(self, system: System, params: CemParams):
        self.system = system
        self.params = params
        f32 = lambda a: None if a is None else jnp.asarray(a, jnp.float32)
        self.Q, self.Qd, self.R = f32(params.Q), f32(params.Qd), f32(params.R)
        self.x0 = f32(params.x0)
        self.xd_trj = f32(params.xd_trj)
        self.u_trj = f32(params.u_trj_init)
        self.T = int(self.u_trj.shape[0])
        self.idx_u = (None if params.indices_u_into_x is None
                      else jnp.asarray(params.indices_u_into_x, jnp.int32))
        init_std = f32(params.initial_std)
        # (m,) broadcasts over the horizon; a full (T, m) std is accepted
        # so a driver can CONTINUE a search (e.g. the annealed noise_knots
        # phases of examples/quadrotor_cem_anneal.py) from a refit std.
        self.std_trj = (init_std if init_std.ndim == 2
                        else jnp.tile(init_std, (self.T, 1)))
        if self.std_trj.shape != (self.T, self.system.dim_u):
            raise ValueError(
                f"initial_std shape {init_std.shape} incompatible with "
                f"(T, m) = {(self.T, self.system.dim_u)}")
        self.key = jax.random.PRNGKey(params.seed)
        if not 0 <= params.momentum < 1:
            raise ValueError(f"momentum must be in [0, 1): {params.momentum}")
        if not 0 <= params.noise_beta < 1:
            raise ValueError(
                f"noise_beta must be in [0, 1): {params.noise_beta}")
        if not 0 <= params.elite_keep <= params.n_elite:
            raise ValueError("elite_keep must be in [0, n_elite]")
        if params.noise_knots < 0 or params.noise_knots > self.T:
            raise ValueError(f"noise_knots must be in [0, T]: "
                             f"{params.noise_knots}")
        if params.noise_knots == 1:
            raise ValueError("noise_knots must be 0 (off) or >= 2")
        self._knot_W = None
        if params.noise_knots >= 2:
            # (T, K) linear-interpolation weights from K knots at
            # linspace(0, T-1, K), rows rescaled to unit marginal variance.
            K = params.noise_knots
            t = np.arange(self.T, dtype=np.float64)
            pos = t * (K - 1) / (self.T - 1) if self.T > 1 else t * 0.0
            lo = np.minimum(np.floor(pos).astype(np.int64), K - 2)
            frac = pos - lo
            W = np.zeros((self.T, K))
            W[t.astype(np.int64), lo] = 1.0 - frac
            W[t.astype(np.int64), lo + 1] = frac
            W /= np.sqrt((W ** 2).sum(axis=1, keepdims=True))
            self._knot_W = jnp.asarray(W, jnp.float32)
        # Persisted elites (elite_keep > 0): start as copies of the nominal,
        # which also guarantees the nominal trajectory is in population 1.
        self.kept = (jnp.tile(self.u_trj[None], (params.elite_keep, 1, 1))
                     if params.elite_keep > 0 else None)

        self.x_trj = system.rollout(self.x0, self.u_trj)
        self.cost = float(self._cost(self.x_trj, self.u_trj))

        self.x_trj_lst = [np.asarray(self.x_trj)]
        self.u_trj_lst = [np.asarray(self.u_trj)]
        self.cost_lst = [self.cost]
        self.cost_best = self.cost
        self.x_trj_best = np.asarray(self.x_trj)
        self.u_trj_best = np.asarray(self.u_trj)
        self.start_time = time.time()
        self.iter = 1
        self._step_jit = jax.jit(self._step)

    # ------------------------------------------------------------------
    def _cost(self, x_trj, u_trj):
        ex = x_trj[:-1] - self.xd_trj[:-1]
        c = jnp.einsum("ti,ij,tj->", ex, self.Q, ex)
        ef = x_trj[-1] - self.xd_trj[-1]
        Qf = self.Q if self.params.report_final_cost_with_Q else self.Qd
        c += ef @ Qf @ ef
        if self.idx_u is None:
            c += jnp.einsum("ti,ij,tj->", u_trj, self.R, u_trj)
        else:
            u_prev = jnp.concatenate(
                [x_trj[0, self.idx_u][None], u_trj[:-1]], axis=0)
            du = u_trj - u_prev
            c += jnp.einsum("ti,ij,tj->", du, self.R, du)
        return c

    def _step(self, u_trj, std_trj, prev_x, prev_cost, kept, key):
        p = self.params
        key, k = jax.random.split(key)
        if self._knot_W is not None:
            eps_k = jax.random.normal(
                k, (p.batch_size, p.noise_knots, self.system.dim_u))
            eps = jnp.einsum("tk,bkm->btm", self._knot_W, eps_k)
        else:
            eps = jax.random.normal(
                k, (p.batch_size, self.T, self.system.dim_u))
        if p.noise_beta > 0 and self._knot_W is None:
            # AR(1) low-pass along the horizon, unit marginal variance.
            beta = jnp.float32(p.noise_beta)
            scale = jnp.sqrt(1.0 - beta * beta)

            def lp(c, w):
                e = beta * c + scale * w
                return e, e

            _, rest = jax.lax.scan(lp, eps[:, 0],
                                   jnp.swapaxes(eps[:, 1:], 0, 1))
            eps = jnp.concatenate(
                [eps[:, :1], jnp.swapaxes(rest, 0, 1)], axis=1)
        cand = u_trj[None] + std_trj[None] * eps
        if kept is not None:
            # Previous elites survive resampling verbatim (first rows).
            cand = cand.at[:p.elite_keep].set(kept)
        if p.u_bounds_abs is not None:
            b = jnp.asarray(p.u_bounds_abs, jnp.float32)
            cand = jnp.clip(cand, b[0], b[1])

        def eval_one(u):
            x = self.system.rollout(self.x0, u)
            return self._cost(x, u)

        with jax.default_matmul_precision("highest"):
            costs = jax.vmap(eval_one)(cand)
        # Diverged rollouts (NaN/inf cost) must never become elites.
        costs = jnp.where(jnp.isfinite(costs), costs, jnp.inf)
        # lowest-cost elites
        _, elite_idx = jax.lax.top_k(-costs, p.n_elite)
        elites = cand[elite_idx]
        u_new = jnp.mean(elites, axis=0)
        std_new = jnp.std(elites, axis=0)
        if p.momentum > 0:
            a = jnp.float32(p.momentum)
            u_new = (1 - a) * u_new + a * u_trj
            std_new = (1 - a) * std_new + a * std_trj
        kept_new = elites[:p.elite_keep] if kept is not None else kept
        x_new = self.system.rollout(self.x0, u_new)
        cost_new = self._cost(x_new, u_new)
        # Divergence guard: the elites' mean rollout can blow up on stiff
        # systems even when each elite was finite-cost.  Fall back to the
        # best single elite (known finite unless the whole population
        # diverged); failing that, keep the previous mean (cost threaded
        # through the carry — no re-rollout) WITHOUT shrinking std, so a bad
        # initial mean can still escape via future populations.
        best_u = cand[elite_idx[0]]
        best_cost = costs[elite_idx[0]]
        bad_mean = ~jnp.isfinite(cost_new)
        use_elite = bad_mean & jnp.isfinite(best_cost)
        use_prev = bad_mean & ~jnp.isfinite(best_cost)

        u_new = jnp.where(use_prev, u_trj, jnp.where(use_elite, best_u, u_new))
        x_new = jnp.where(
            use_prev, prev_x,
            jnp.where(use_elite, self.system.rollout(self.x0, best_u), x_new))
        cost_new = jnp.where(use_prev, prev_cost,
                             jnp.where(use_elite, best_cost, cost_new))
        std_new = jnp.where(use_prev, std_trj,
                            jnp.where(use_elite, 0.5 * std_trj, std_new))
        if p.std_floor is not None:
            std_new = jnp.maximum(std_new,
                                  jnp.asarray(p.std_floor, jnp.float32))
        return x_new, u_new, std_new, cost_new, kept_new, key

    # ------------------------------------------------------------------
    def iterate(self, max_iterations: int, verbose: bool = True):
        for _ in range(max_iterations):
            (x_new, u_new, std_new, cost_new, self.kept,
             self.key) = self._step_jit(
                self.u_trj, self.std_trj, self.x_trj,
                jnp.asarray(self.cost, jnp.float32), self.kept, self.key)
            cost_new = float(cost_new)
            if verbose:
                print(f"Iteration: {self.iter:02d} || Current Cost: "
                      f"{cost_new:.6f} || Elapsed time: "
                      f"{time.time() - self.start_time:.5f}")
            self.x_trj_lst.append(np.asarray(x_new))
            self.u_trj_lst.append(np.asarray(u_new))
            self.cost_lst.append(cost_new)
            if cost_new < self.cost_best:
                self.cost_best = cost_new
                self.x_trj_best = np.asarray(x_new)
                self.u_trj_best = np.asarray(u_new)
            self.x_trj, self.u_trj, self.std_trj = x_new, u_new, std_new
            self.cost = cost_new
            self.iter += 1
        return self.x_trj, self.u_trj, self.cost
