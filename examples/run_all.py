"""Run every example driver end-to-end and regenerate all analysis
artifacts (cost CSVs + aggregate plot).  ~10-20 min on CPU.

Usage:  python examples/run_all.py [--check [--save-to DIR]] [--cpu]
                                   [driver ...]

Positional driver names restrict the sweep (e.g. ``run_all.py --check
planar_hand box_pivoting``); ``--cpu`` forces the XLA CPU backend with an
8-device virtual mesh.

``--check`` turns the run into a full-budget regression gate (the
accelerator-side counterpart of tests/test_golden_contact.py's
reduced-budget CPU locks):
every regenerated single-column cost curve is asserted against the
committed CSV — initial cost to 0.1% (deterministic rollout), best cost to
+-12% (estimator-RNG/backend tolerance, matching the golden suite) — the
committed files are restored afterwards (check mode is side-effect-free),
and the exit code is nonzero on any drift.  This formalizes the
reference's implicit golden-CSV discipline (SURVEY §4.4) instead of
letting curve regressions land as silent CSV churn.  ``--save-to DIR``
also copies every regenerated curve into DIR before the committed ones are
restored, so curves that moved for a stated reason can be re-committed.
"""
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

DRIVERS = [
    "pendulum", "bicycle", "quadrotor", "three_cart", "pendulum_nn",
    "planar_hand", "planar_hand_cem", "planar_hand_spin",
    "planar_hand_second_order", "box_pushing", "box_pushing_cem",
    "box_pushing_second_order", "box_pivoting", "plate_pickup", "carrots",
]

ANALYSIS = Path(__file__).resolve().parent / "analysis"
REL_TOL_BEST = 0.12
REL_TOL_INITIAL = 1e-3


def _snapshot_curves():
    """Committed cost curves: {name: bytes} for every analysis CSV."""
    return {p.name: p.read_bytes() for p in ANALYSIS.glob("*.csv")}


def _is_cost_curve(text: str) -> bool:
    """Single-column numeric CSV with >= 2 rows = a cost-vs-iteration curve
    (probe/bracket artifacts are multi-column and not asserted)."""
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    if len(lines) < 2:
        return False
    try:
        return all("," not in ln and float(ln) == float(ln) for ln in lines)
    except ValueError:
        return False


def _check_curves(before: dict) -> list:
    """Compare regenerated curves against the committed snapshot."""
    import numpy as np
    drifts = []
    for p in sorted(ANALYSIS.glob("*.csv")):
        old = before.get(p.name)
        if old is None:
            continue                      # newly created artifact: no lock
        old_text = old.decode()
        new_text = p.read_text()
        if not (_is_cost_curve(old_text) and _is_cost_curve(new_text)):
            continue
        c_new = np.fromstring(new_text, sep="\n")
        c_old = np.fromstring(old_text, sep="\n")
        if abs(c_new[0] - c_old[0]) > REL_TOL_INITIAL * abs(c_old[0]):
            drifts.append((p.name, "initial", float(c_old[0]),
                           float(c_new[0])))
        b_old, b_new = float(c_old.min()), float(c_new.min())
        if abs(b_new - b_old) > REL_TOL_BEST * abs(b_old):
            drifts.append((p.name, "best", b_old, b_new))
    return drifts


def main():
    check = "--check" in sys.argv
    save_to = None
    args = sys.argv[1:]
    if "--save-to" in args:
        i = args.index("--save-to")
        save_to = Path(args[i + 1])
        del args[i:i + 2]
    only = [a for a in args if not a.startswith("-")]
    drivers = [d for d in DRIVERS if d in only] if only else DRIVERS
    t_total = time.time()
    failures = []
    before = _snapshot_curves() if check else {}
    for name in drivers:
        t0 = time.time()
        print(f"=== {name} ===", flush=True)
        try:
            mod = __import__(name)
            mod.main()
        except Exception as e:   # keep going; report at the end
            failures.append((name, repr(e)))
            print(f"  FAILED: {e!r}")
        print(f"  ({time.time() - t0:.1f}s)", flush=True)
    drifts = []
    if check:
        drifts = _check_curves(before)
        if save_to is not None:
            save_to.mkdir(parents=True, exist_ok=True)
            for p in ANALYSIS.glob("*.csv"):
                (save_to / p.name).write_bytes(p.read_bytes())
        # Side-effect-free: restore the committed artifacts.
        for fname, data in before.items():
            (ANALYSIS / fname).write_bytes(data)
    else:
        import plot_all
        plot_all.main()
    print(f"total: {time.time() - t_total:.1f}s; "
          f"{len(drivers) - len(failures)}/{len(drivers)} drivers OK")
    for name, err in failures:
        print(f"  FAILED {name}: {err}")
    if check:
        for fname, what, old, new in drifts:
            print(f"  DRIFT {fname} [{what}]: committed {old:.4f} -> "
                  f"regenerated {new:.4f}")
        if not drifts and not failures:
            print("CHECK OK: all regenerated curves match the committed "
                  "CSVs (initial 0.1%, best 12%)")
    return failures or drifts


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
