"""chip_smoke.py and bench.py refuse to run without a GPU: non-zero exit
and no result line (chip_smoke.py both from the checkout and from a
directory that holds the script alone)."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    if where == "checkout":
        cwd = ROOT
    else:
        cwd = str(tmp_path)
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), cwd)
    env = {"JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", ""),
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jc")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    if where == "checkout":
        assert "no GPU" in out.stderr


def test_bench_fails_without_gpu(tmp_path):
    """bench.py never times the XLA twins or the interpreter in place of
    the kernels: on a CPU backend it stops before any config."""
    env = {"JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", ""),
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jc")}
    out = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no GPU" in out.stderr and "config[" not in out.stderr
