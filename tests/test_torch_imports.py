"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)\b(?!_)",
                       re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)],
                                                        prefix="repro_torch."))


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = _modules()
    assert "repro_torch.serve.loop" in mods and len(mods) >= 15
    assert {"repro_torch.core.engine", "repro_torch.kernels.elementwise",
            "repro_torch.kernels.attention", "repro_torch.runtime.scheduler",
            "repro_torch.configs.zamba2_2_7b", "repro_torch.obs.profile",
            "repro_torch.obs.critical_path", "repro_torch.obs.__main__",
            "repro_torch.faults.plan", "repro_torch.faults.injector",
            "repro_torch.serve.offload", "repro_torch.sharding.rules",
            "repro_torch.configs.mixtral_8x22b", "repro_torch.models.moe",
            "repro_torch.configs.deepseek_v3_671b",
            "repro_torch.serve.__main__", "repro_torch.optim.adamw",
            "repro_torch.optim.compression", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.ckpt", "repro_torch.train.loop",
            "repro_torch.train.__main__", "repro_torch.sharding.context",
            "repro_torch.launch.mesh", "repro_torch.launch.steps",
            "repro_torch.launch.params", "repro_torch.launch.modelflops",
            "repro_torch.launch.memmodel", "repro_torch.launch.traceanalysis",
            "repro_torch.launch.dryrun", "repro_torch.launch.attribute",
            "repro_torch.launch.distributed_train",
            "repro_torch.quickstart"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_hold_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders
    # the pattern itself catches what it must and spares the port's name
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.kernels import ops")
    assert not FORBIDDEN.search("from repro_torch.kernels import ops")


def test_core_does_not_import_the_model_stack():
    """``repro_torch.core``, the AME engine, sits below the models: it
    resolves its device through ``launch.device``, not ``models``."""
    code = ("import sys, repro_torch.core\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.startswith(('repro_torch.models', "
            "'repro_torch.serve')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_runtime_does_not_import_the_model_stack_or_the_kernels():
    """``repro_torch.runtime``, the multi-channel PIM runtime, sits on the
    engine (``core``): it imports no model, serving or kernel module."""
    code = ("import sys, repro_torch.runtime\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.startswith(('repro_torch.models', "
            "'repro_torch.serve', 'repro_torch.kernels')))\n"
            "assert not bad, bad\n"
            "assert 'repro_torch.core.engine' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_obs_and_faults_do_not_import_the_model_stack_or_the_kernels():
    """``repro_torch.obs`` and ``repro_torch.faults`` sit on the runtime:
    they import no model, serving or kernel module."""
    code = ("import sys, repro_torch.obs, repro_torch.faults\n"
            "import repro_torch.obs.__main__\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.startswith(('repro_torch.models', "
            "'repro_torch.serve', 'repro_torch.kernels')))\n"
            "assert not bad, bad\n"
            "assert 'repro_torch.runtime.scheduler' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
