"""Annealed band-limited CEM on the quadrotor helix (the r3-verdict probe).

Round-3 state of the 800-dim quadrotor CEM search: vanilla 16000/1200
plateaus at ~8.2k (vs iRS's 3.29k); STATIC band-limited noise
(noise_knots=40) stalls at 17.5k because the helix needs fine per-knot
corrections late in the search.  The untested hypothesis: a coarse-to-fine
SCHEDULE — explore coherent low-frequency maneuvers early (where vanilla
CEM wastes its budget fighting per-knot jitter), then hand the mean + refit
std to progressively finer phases that can express the corrections.

Phases (each continues from the previous mean and per-knot refit std —
CemParams.initial_std accepts a full (T, m) array for this):
    1. noise_knots=20,  400 refits   (coarse maneuvers)
    2. noise_knots=67,  400 refits   (mid-band)
    3. noise_knots=0,   400 refits   (full per-knot resolution)
Equal total budget to the recorded vanilla run (16000 x 1200).

Artifact: analysis/quadrotor_cem_anneal.csv (concatenated cost curve) and
a printed per-phase summary consumed by PARITY.md — either the anneal
breaks the ~8k plateau or it pins the plateau as schedule-independent.

OUTCOME (recorded run): phase bests 22967 -> 11024 -> 9250.  The
coarse phase plateaus far above vanilla (the helix cannot even be tracked
at 20-knot resolution) and the fine phases recover only to 9.25k — WORSE
than vanilla's 8.2k at equal total budget.  Together with the static
noise_knots stall (17.5k) this pins the ~8k plateau as schedule-
independent: every tested exploration structure (white, AR(1), band-
limited, annealed) lands at 8-17k while gradient-based iRS reaches 3.3k.
The residual is the CEM-vs-gradient gap at 800 dimensions, not a tuning
artifact.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from common import ANALYSIS_DIR
from quadrotor import helix_xd

from irs_mpc_tpu import make_quadrotor
from irs_mpc_tpu.solvers.cem import CemParams, CrossEntropyMethod


def build(T=200, batch_size=16000, n_elite=160, noise_knots=0,
          u_trj_init=None, initial_std=None, seed=0):
    return CrossEntropyMethod(make_quadrotor(0.05), CemParams(
        Q=1.0 * np.diag([10.] * 6 + [0.] * 6),
        Qd=10.0 * np.diag([10.] * 6 + [1.] * 6),
        R=np.eye(4),
        x0=np.zeros(12), xd_trj=helix_xd(T),
        u_trj_init=(np.tile([2.0] * 4, (T, 1)) if u_trj_init is None
                    else u_trj_init),
        n_elite=n_elite, batch_size=batch_size,
        initial_std=(np.ones(4) * 0.02 if initial_std is None
                     else initial_std),
        noise_beta=0.5, momentum=0.1, elite_keep=min(20, n_elite),
        noise_knots=noise_knots,
        u_bounds_abs=np.array([np.zeros(4), 4.0 * np.ones(4)]),
        seed=seed))


def main(phase_iters=400):
    curve = []
    u, std = None, None
    for i, knots in enumerate((20, 67, 0)):
        cem = build(noise_knots=knots, u_trj_init=u, initial_std=std,
                    seed=i)
        cem.iterate(phase_iters, verbose=False)
        # Continue from the refit state, floored so the next phase retains
        # exploration headroom.
        u = np.asarray(cem.u_trj_best, np.float32)
        std = np.maximum(np.asarray(cem.std_trj, np.float32), 0.005)
        curve += cem.cost_lst[1:] if curve else cem.cost_lst
        print(f"[phase {i + 1}: noise_knots={knots}] "
              f"best {cem.cost_best:.1f} final {cem.cost:.1f}", flush=True)
    np.savetxt(ANALYSIS_DIR / "quadrotor_cem_anneal.csv",
               np.asarray(curve))
    print("anneal best overall:", min(curve))


if __name__ == "__main__":
    main()
