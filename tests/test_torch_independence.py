"""The PyTorch port stands alone: it imports without jax, pyarrow or
protobuf, no file of it (nor chip_smoke.py) imports jax or the JAX package,
and its default device is the GPU — without one it raises rather than
continuing on the CPU.
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import blaze_tpu_torch
from blaze_tpu_torch.utils import device as device_mod

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "blaze_tpu_torch")

_BLOCKER = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "pyarrow") or name.startswith("google.protobuf") \
                or top == "blaze_tpu":
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import importlib, pkgutil
import blaze_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(blaze_tpu_torch.__path__, "blaze_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "pyarrow", "blaze_tpu")]
print("ok", len(mods))
"""


def test_imports_with_jax_pyarrow_protobuf_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 15  # every module of the slice


_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M),
    re.compile(r"\bfrom\s+blaze_tpu[.\s]"),
    re.compile(r"\bimport\s+blaze_tpu(?![\w])"),
    re.compile(r"pyarrow"),
]


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_no_file_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            text = f.read()
        for pat in _FORBIDDEN:
            if pat.search(text):
                offenders.append((os.path.relpath(path, ROOT), pat.pattern))
    assert not offenders, offenders
    assert len(_port_files()) >= 20


def test_default_session_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blaze_tpu_torch.Session()
    with pytest.raises(RuntimeError):
        device_mod.resolve_device("cuda")
    assert blaze_tpu_torch.Session(device="cpu").device == torch.device("cpu")


def test_every_module_is_listed_in_the_package():
    names = {m.name for m in pkgutil.walk_packages(blaze_tpu_torch.__path__,
                                                    "blaze_tpu_torch.")}
    for mod in ("config", "utils.device", "utils.cuda_lib", "ir.types", "ir.exprs",
                "ir.nodes", "ir.carry", "core.batch", "core.kernels",
                "exprs.decimal", "exprs.compiler", "exprs.spark_hash", "ops.base",
                "ops.basic", "ops.shuffle.reader", "ops.shuffle.repartitioner",
                "ops.aggfns", "ops.agg_device", "ops.agg", "ops.sort_keys",
                "ops.sort", "runtime.executor", "runtime.session"):
        assert "blaze_tpu_torch." + mod in names
