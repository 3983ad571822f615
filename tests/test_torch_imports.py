"""The PyTorch port imports neither jax nor the JAX package (whisper_tpu):
not its package, not chip_smoke.py. It keeps its own copies of the JAX-free
host modules (tests/test_torch_host_layer.py holds them to the originals)."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None  # any 'import jax' now raises ImportError
sys.modules["whisper_tpu"] = None  # and so does any import of the JAX package
import importlib, pkgutil
import whisper_tpu_torch
names = [m.name for m in pkgutil.walk_packages(whisper_tpu_torch.__path__, "whisper_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert len(names) >= 61, names
for entry in ("cli", "runtime.native", "utils.benchmark", "pipeline.chunked",
              "pipeline.streaming", "utils.synth", "parallel.beam_engine", "parallel.server"):
    assert "whisper_tpu_torch." + entry in names, entry
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_port_source_names_jax():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|whisper_tpu)(\.|\s|$)", re.MULTILINE)
    files = sorted((ROOT / "whisper_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())]
    assert offenders == []
