"""Golden-convergence regression locks for the five contact systems.

The committed cost curves under ``examples/analysis/`` are the framework's
de-facto regression baselines — exactly the role the reference's CSVs play
(``/root/reference/examples/planar_hand/run_planar_hand.py:196-197``,
SURVEY §4.4) — but curves in files rot silently.  These tests formalize
that discipline: deterministic-seed, reduced-budget (8-descent) runs of
every contact example with tolerance assertions on the final cost, so a
code change that quietly degrades a contact curve FAILS CI instead of
rotting the CSVs (the round-2 doc/CSV-drift lesson).

Budget note: 8 descents is enough to be deep into each curve's contact-rich
regime (planar-hand 325 -> ~22 of an eventual ~14.5) while keeping CPU CI
tractable; carrots (45 dof, 20 objects) runs 3 descents for the same
reason.  Expected values were calibrated on the CPU backend (the CI
platform, XLA ADMM path) at seed 0; the GPU path is locked separately by
chip_smoke.py's checks and the committed CSVs (run_all.py --check).

Tolerance: ±12% relative on the converged cost — wide enough for cross-
version XLA CPU drift and estimator RNG sensitivity under legitimate
refactors (different-but-equivalent sample streams), tight enough that the
r2-class regressions these exist to catch (planar-hand 14.5 -> 20: +38%)
fail loudly.  Initial costs are deterministic rollouts and locked to 0.1%.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

# (example module, n_descents, expected initial, expected best cost)
GOLDEN = [
    ("planar_hand", 8, 325.0136, 22.26),
    ("box_pushing", 8, 134.4132, 46.16),
    ("box_pivoting", 8, 786.3928, 317.41),
    ("plate_pickup", 8, 482.9550, 3.216),
]

REL_TOL = 0.12


def _run(module_name, n_descents):
    import importlib
    mod = importlib.import_module(module_name)
    out = mod.build_solver()
    solver = out[0] if isinstance(out, tuple) else out
    solver.iterate(n_descents, verbose=False)
    return solver


@pytest.mark.parametrize("module_name,n_descents,c0,c_best", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_contact_final(module_name, n_descents, c0, c_best):
    solver = _run(module_name, n_descents)
    np.testing.assert_allclose(solver.cost_lst[0], c0, rtol=1e-3)
    assert abs(solver.cost_best - c_best) <= REL_TOL * c_best, (
        f"{module_name}: best cost {solver.cost_best:.4f} drifted more than "
        f"{REL_TOL:.0%} from the golden {c_best:.4f} at {n_descents} "
        f"descents — a change degraded (or improved: recalibrate) the "
        f"convergence curve")


def test_golden_contact_final_carrots():
    """45-dof 20-object pile at 3 descents (its per-descent cost dominates
    CI time; 3 descents already locks the plow-pass descent rate)."""
    solver = _run("carrots", 3)
    np.testing.assert_allclose(solver.cost_lst[0], 211.8252, rtol=1e-3)
    c_best = 172.98
    assert abs(solver.cost_best - c_best) <= REL_TOL * c_best, (
        f"carrots: best cost {solver.cost_best:.4f} drifted more than "
        f"{REL_TOL:.0%} from the golden {c_best:.4f}")
