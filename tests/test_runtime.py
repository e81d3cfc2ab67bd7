"""Entry-script plumbing: the compile-cache helper, bench.py's peak-rate
table, and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _run(code_or_args, env_extra=None, cwd=ROOT, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", **(env_extra or {}))
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable] + code_or_args)
    return subprocess.run(args, env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=300)


_PROBE = ("import jax; from irs_mpc_tpu.utils.runtime import "
          "setup_compile_cache as s; print(s()); "
          "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_defaults_to_checkout_dir():
    r = _run(_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    used, configured = r.stdout.split()
    assert used == configured == str(ROOT / ".jax_cache")


def test_compile_cache_honours_environment(tmp_path):
    r = _run(_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    used, configured = r.stdout.split()
    assert used == configured == str(tmp_path)


@pytest.mark.parametrize("kind,key,value", [
    ("NVIDIA H100 80GB HBM3", "f32", 67e12),
    ("NVIDIA H100 80GB HBM3", "tf32", 495e12),
    ("NVIDIA H100 80GB HBM3", "bf16", 989e12),
    ("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s", 3.35e12),
])
def test_peaks_table(kind, key, value):
    import bench
    assert bench.peaks(kind)[key] == value
    assert bench.peaks(kind)["source"]


def test_unknown_device_has_no_peaks():
    import bench
    with pytest.raises(ValueError, match="no peak rates"):
        bench.peaks("cpu")
    with pytest.raises(ValueError, match="no peak rates"):
        bench.roofline_fields(1e9, 1e6, 1e-3)   # this process is on the CPU


def test_bench_refuses_the_cpu():
    r = _run(["bench.py"])
    assert r.returncode != 0
    assert "measures the GPU" in r.stderr
    assert '"metric"' not in r.stdout


def test_chip_smoke_fails_without_a_gpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    (on a CPU-only machine) it must fail and print no result either."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]


def test_main_path_imports_no_optional_packages():
    """chip_smoke.py's main path needs only numpy, scipy and jax: flax
    (models/mlp.py) and matplotlib (viz, plots) may be missing on the GPU
    machine."""
    code = ("import sys; sys.path[:0] = ['.', 'examples']; "
            "import chip_smoke, irs_mpc_tpu, planar_hand, "
            "planar_hand_second_order; "
            "from irs_mpc_tpu.models.contact import systems; "
            "from irs_mpc_tpu.parallel import sharded; "
            "from irs_mpc_tpu.native import boxed_tvlqr_oracle; "
            "print(sorted(m for m in ('flax', 'matplotlib', 'torch') "
            "if m in sys.modules))")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
