"""Multi-device SPMD estimation: mesh-sharded Monte-Carlo linearization.

Replaces the reference's entire L2 layer — the ZMQ PUSH/PULL ventilator /
worker / sink task farm over TCP with per-process simulator copies and a
manual startup barrier (``/root/reference/zmq_parallel_cmp/``,
``irs_lqr_quasistatic.py:117-129, 228-273``,
``examples/planar_hand/planar_hand_worker.py``) — with a single SPMD program
under ``shard_map`` on a ``jax.sharding.Mesh``:

* axis ``knot``   — the time dimension (the reference's only distribution
                    axis, via ``task_stride`` strided tasks);
* axis ``sample`` — the Monte-Carlo sample batch (the reference has no
                    distribution here at all).

Per-sample regression moments (G = S'S, M = S'D) are reduced with ``psum``
over the ``sample`` axis — on GPUs this rides NVLink (NCCL), and across
hosts the network only ever sees the tiny (p,p)/(p,n) moment tensors per
knot (SURVEY §5.8).
No sockets, no pickling, no lost-worker deadlock: failure semantics are
XLA's, and determinism is by construction (keys are split per (knot, shard)).
"""
from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.base import System
from ..ops.estimators import (SmoothingConfig, TvLinearization,
                              fit_from_moments)

Array = jax.Array


def make_mesh(n_sample: int = 1, n_knot: int = 1,
              devices=None) -> Mesh:
    """Build a (sample, knot) device mesh.  Total devices must equal
    n_sample * n_knot."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size == n_sample * n_knot, (
        f"need {n_sample * n_knot} devices, have {devices.size}")
    return Mesh(devices.reshape(n_sample, n_knot), axis_names=("sample",
                                                               "knot"))


def default_mesh(devices=None) -> Mesh:
    """Heuristic mesh over all devices: favor the sample axis (largest,
    embarrassingly parallel), square-ish split if possible."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    n_knot = 1
    for cand in (4, 2):
        if n % cand == 0 and n // cand >= 2:
            n_knot = cand
            break
    return make_mesh(n // n_knot, n_knot, devices)


def _pad_T(T: int, shards: int) -> int:
    return ((T + shards - 1) // shards) * shards


def sharded_estimate_tv_matrices(
        system: System,
        mode: str,
        x_trj: Array,          # (T+1, n) replicated
        u_trj: Array,          # (T, m) replicated
        key: Array,
        it: Array,
        cfg: SmoothingConfig,
        mesh: Mesh) -> TvLinearization:
    """Mesh-sharded version of ``estimate_tv_matrices``: knots split over the
    ``knot`` axis, samples over the ``sample`` axis, moments psum-reduced.

    Statistically identical to the single-device path (same estimator, same
    sample count) but NOT bitwise-identical to it (keys are split per shard).
    Deterministic for a fixed mesh shape + key.
    """
    T = int(u_trj.shape[0])
    n, m = system.dim_x, system.dim_u
    n_sample = mesh.shape["sample"]
    n_knot = mesh.shape["knot"]
    Tp = _pad_T(T, n_knot)
    S_local = max(1, cfg.num_samples // n_sample)

    # Pad the knot axis (padded knots compute garbage that is sliced off).
    x_pad = jnp.concatenate(
        [x_trj[:-1], jnp.broadcast_to(x_trj[-1], (Tp - T, n))], axis=0)
    u_pad = jnp.concatenate(
        [u_trj, jnp.zeros((Tp - T, m), u_trj.dtype)], axis=0)
    keys = jax.random.split(key, Tp)            # (Tp, 2) one key per knot
    sx, su = cfg.stds(it, n, m)

    if mode not in ("exact", "first_order", "zero_order", "zero_order_B",
                    "zero_order_AB"):
        raise ValueError(f"unknown mode {mode!r}")

    from ..ops.estimators import _flat_call

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("knot"), P("knot"), P("knot")),
             out_specs=P("knot"))
    def run(x_k, u_k, keys_k):
        """Per-device sweep over the local knot shard.

        The heavy operators (step_batch / jacobian_xu_batch) run over ONE
        flat (T_local * S_local) batch, as in ops/estimators.py.  Per-knot
        least-squares moments are then reduced with one psum over the
        sample axis.
        """
        shard_id = jax.lax.axis_index("sample")

        def draw(knot_key):
            k = jax.random.fold_in(knot_key, shard_id)
            kx, ku = jax.random.split(k)
            return (sx * jax.random.normal(kx, (S_local, n)),
                    su * jax.random.normal(ku, (S_local, m)))

        if mode == "exact":
            return system.jacobian_xu_batch(x_k, u_k)

        dx, du = jax.vmap(draw)(keys_k)          # (T_loc, S_loc, n/m)
        # Projection applies only where the reference estimators use it
        # (first_order / zero_order); zero_order_B and zero_order_AB fit
        # raw perturbations (mirrors ops/estimators._estimate_flat).
        if system.projection is not None and mode in ("first_order",
                                                      "zero_order"):
            xp, up = jax.vmap(system.projection)(x_k, dx, u_k, du)
        else:
            xp, up = x_k[:, None] + dx, u_k[:, None] + du

        if mode == "first_order":
            ABs = _flat_call(system.jacobian_xu_batch, xp, up)
            AB = jax.lax.psum(jnp.sum(ABs, axis=1), "sample") \
                / (S_local * n_sample)
            return AB

        f0 = system.step_batch(x_k, u_k)
        if mode == "zero_order":
            if system.projection is not None:
                dx, du = xp - x_k[:, None], up - u_k[:, None]
            fd = _flat_call(system.step_batch, xp, up)
            S = jnp.concatenate([dx, du], axis=2)
            G = jax.lax.psum(jnp.einsum("tsp,tsq->tpq", S, S), "sample")
            M = jax.lax.psum(
                jnp.einsum("tsp,tsn->tpn", S, fd - f0[:, None]), "sample")
            return jax.vmap(fit_from_moments)(G, M)

        if mode == "zero_order_B":
            xb = jnp.broadcast_to(x_k[:, None], dx.shape)
            ub = u_k[:, None] + du
            fd = _flat_call(system.step_batch, xb, ub)
            G = jax.lax.psum(jnp.einsum("tsp,tsq->tpq", du, du), "sample")
            M = jax.lax.psum(
                jnp.einsum("tsp,tsn->tpn", du, fd - f0[:, None]), "sample")
            B_hat = jax.vmap(fit_from_moments)(G, M)
            if cfg.zero_order_B_A_source == "first_order":
                # MBP reference semantics (mbp_dynamics.py:387-389): A from
                # Jacobians averaged over the same u-samples.
                ABj = _flat_call(system.jacobian_xu_batch, xb, ub)
                A_hat = jax.lax.psum(
                    jnp.sum(ABj[:, :, :, :n], axis=1), "sample") \
                    / (S_local * n_sample)
            else:
                A_hat = system.jacobian_xu_batch(x_k, u_k)[:, :, :n]
            return jnp.concatenate([A_hat, B_hat], axis=2)

        # zero_order_AB
        fd = _flat_call(system.step_batch, xp, up)
        S = jnp.concatenate([dx, du], axis=2)
        G = jax.lax.psum(jnp.einsum("tsp,tsq->tpq", S, S), "sample")
        M = jax.lax.psum(
            jnp.einsum("tsp,tsn->tpn", S, fd - f0[:, None]), "sample")
        return jax.vmap(
            lambda Gi, Mi: fit_from_moments(Gi, Mi, damp=cfg.damp))(G, M)

    AB = run(x_pad, u_pad, keys)[:T]
    A, B = AB[:, :, :n], AB[:, :, n:]
    f_nom = system.step_batch(x_trj[:-1], u_trj)
    c = f_nom - jnp.einsum("tij,tj->ti", A, x_trj[:-1]) \
        - jnp.einsum("tij,tj->ti", B, u_trj)
    return TvLinearization(A=A, B=B, c=c)
