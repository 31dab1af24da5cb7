"""The port stands alone: every ``repro_torch`` module and
``chip_smoke.py`` import with ``jax``, ``jaxlib``, ``ml_dtypes`` and
``repro`` refused (a fresh interpreter with a meta-path hook; names match
exactly, so ``repro_torch`` itself passes)."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

BANNED = {"jax", "jaxlib", "ml_dtypes", "repro"}
refused = []


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            refused.append(name)
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import repro_torch

names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)             # import only: no main()
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BANNED)
assert not leaked, leaked
assert not refused, refused
print(len(names), "modules")
print(" ".join(names))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 71, proc.stdout
    names = set(proc.stdout.splitlines()[1].split())
    for name in ("checkpoint", "checkpoint.manager", "runtime",
                 "runtime.fault_tolerance", "launch.roofline",
                 "serving.fleet", "serving.fleet.admission",
                 "serving.fleet.fleet", "serving.fleet.replica",
                 "serving.fleet.router", "serving.fleet.trace"):
        assert f"repro_torch.{name}" in names, name


def test_kernels_layer_imports_no_collectives():
    """The kernels sit below the collectives: importing ``kernels.ops``
    (as serving and training do) loads none of the engine."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    probe = ("import sys, repro_torch.kernels.ops\n"
             "up = sorted(n for n in sys.modules\n"
             "            if n.startswith(('repro_torch.collectives',\n"
             "                             'repro_torch.core')))\n"
             "assert not up, up\n")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
