"""Shared example-driver scaffolding.

The reference repeats an identical driver template across examples
(SURVEY §2.3 "driver anatomy") and saves per-iteration cost curves into
``examples/*/analysis/*.csv`` as its de-facto regression baselines; the
helpers here provide the same artifact flow for this framework.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from irs_mpc_tpu.utils.runtime import setup_compile_cache

setup_compile_cache()

ANALYSIS_DIR = Path(__file__).resolve().parent / "analysis"


def save_cost_curve(name: str, cost_lst):
    """np.savetxt of the per-iteration costs (reference:
    run_planar_hand.py:196-197)."""
    ANALYSIS_DIR.mkdir(exist_ok=True)
    path = ANALYSIS_DIR / f"{name}.csv"
    np.savetxt(path, np.asarray(cost_lst), delimiter=",")
    return path


def report(solver, name: str, save: bool = True):
    print(f"[{name}] initial cost: {solver.cost_lst[0]:.4f}  "
          f"final: {solver.cost:.4f}  best: {solver.cost_best:.4f}")
    if save:
        save_cost_curve(name, solver.cost_lst)
