"""``python -m repro_torch.quickstart`` against the reference's
``examples/quickstart.py``, on the CPU.

The reference runs in a subprocess (with ``JAX_PLATFORMS=cpu``): it draws
its inputs from a module-level generator, which importing it here would
share.  Every printed line is held ``==``, except the kernel line, which
names what ran (the reference's Pallas kernel in interpret mode, the
port's plain version of K1 here).  The numbers are modeled Aquabolt-XL
cycles and rates, which do not depend on the machine.
"""
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import quickstart

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
KERNEL_LINE = "ame_gemm ("


def _port_lines(device="cpu"):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert quickstart.main(device) == 0
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def reference_lines():
    r = subprocess.run([sys.executable, "examples/quickstart.py"], cwd=ROOT,
                       env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.splitlines()


def _split(lines):
    kernel = [i for i, line in enumerate(lines)
              if line.startswith(KERNEL_LINE)]
    assert len(kernel) == 1, lines
    return lines[:kernel[0]] + lines[kernel[0] + 1:], lines[kernel[0]]


def test_quickstart_prints_the_reference_lines(reference_lines):
    lines = _port_lines()
    ref_rest, ref_kernel = _split(reference_lines)
    rest, kernel = _split(lines)
    assert rest == ref_rest
    assert rest[-1] == "quickstart OK"
    assert ref_kernel.startswith("ame_gemm (output-stationary Pallas kernel")
    assert kernel == "ame_gemm (plain version, CPU): max err 0.00e+00"
    # the kernel line sits where the reference prints its own
    assert reference_lines.index(ref_kernel) == lines.index(kernel)


def test_two_calls_print_the_same_lines():
    """The generator is made inside ``main``: a second call in the same
    process draws the same inputs."""
    assert _port_lines() == _port_lines()


def test_cli_default_is_the_card_with_no_cpu_fallback():
    r = subprocess.run([sys.executable, "-m", "repro_torch.quickstart"],
                       cwd=ROOT, env=ENV, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert "quickstart OK" not in r.stdout


def test_cli_runs_on_the_cpu_when_asked():
    r = subprocess.run([sys.executable, "-m", "repro_torch.quickstart",
                        "--device", "cpu"], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.splitlines() == _port_lines()
