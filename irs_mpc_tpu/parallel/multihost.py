"""Multi-host runtime initialization.

The reference's multi-process story is hand-rolled: spawn N worker
processes, connect ZMQ sockets, and hit Enter when ready
(``irs_lqr_quasistatic.py:117-129``); a lost worker deadlocks the gather
loop (SURVEY §5.3).  On a GPU cluster the JAX multi-process runtime
replaces all of it: every process runs the same SPMD program, collectives
go through NCCL (NVLink within a host, the network across hosts), and
failure semantics are the runtime's (a dead process fails the step loudly
instead of deadlocking silently).

Usage (same script in every process, one process per host or per GPU):

    from irs_mpc_tpu.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = multihost.pod_mesh(knot_shards=1)
    params.mesh = mesh

With no arguments, ``initialize`` relies on a cluster launcher that JAX
detects (Slurm, Open MPI); on a single host it is a no-op and the mesh
covers the local devices.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .sharded import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed (no-op if single-process or already up).

    With no arguments, relies on the cluster launcher's environment (Slurm,
    Open MPI) that ``jax.distributed`` auto-detects.
    """
    # NOTE: do NOT probe jax.process_count() here — it initializes the
    # backend, after which jax.distributed.initialize is forever too late.
    from jax._src import distributed as _distributed
    if getattr(_distributed.global_state, "client", None) is not None:
        return  # already initialized
    explicit = coordinator_address is not None
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except (ValueError, RuntimeError):
        if explicit:
            # The caller named a coordinator: failing to reach it is a real
            # error, not a single-process environment.
            raise
        # No launcher detected (e.g. a single-GPU workstation): run
        # single-process.
        pass


def pod_mesh(knot_shards: int = 1) -> "jax.sharding.Mesh":
    """Build the (sample, knot) mesh over ALL devices in the job.

    Layout rule: the sample axis — which carries the psum of regression
    moments every sweep — is laid out within hosts first so its collective
    stays on NVLink; the knot axis (touched only by the final gather) spans
    hosts.
    """
    devices = np.asarray(jax.devices())
    n = devices.size
    if n % knot_shards != 0:
        raise ValueError(f"{n} devices not divisible by {knot_shards}")
    return make_mesh(n // knot_shards, knot_shards, devices)


def is_coordinator() -> bool:
    return jax.process_index() == 0
