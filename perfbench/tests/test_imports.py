import ast
import os
import subprocess
import sys
from pathlib import Path

from perfbench import families

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import sys
import perfbench.run, perfbench.cell, perfbench.check, perfbench.trace
import perfbench.layers, perfbench.flops, perfbench.roofline, perfbench.traffic
import perfbench.reference.model, perfbench.reference.mel, perfbench.reference.rules
import perfbench.families, perfbench.weights
from perfbench.tests.rehearsal import rehearse
from perfbench.run import FORBIDDEN, forbidden_modules, load_spec, metric_reader
for m in load_spec()["per_layer"]:
    metric_reader(m["name"])
spec, cell, out = rehearse("large-v3-turbo.batch-int8", seconds=8.0)
assert "whisper_tpu_torch" in sys.modules
bad = forbidden_modules()
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    """Top-level names compared whole: whisper_tpu_torch passes, whisper_tpu
    and jax do not."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    assert "FORBIDDEN []" in p.stdout


def reference_modules() -> set:
    """The ``perfbench.reference`` modules that the modules of the family
    directory import, found in their sources."""
    found = set()
    for path in sorted(families.DIR.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            found |= {n for n in names if n.startswith("perfbench.reference.") and _is_module(n)}
    return found


def _is_module(name: str) -> bool:
    path = ROOT / name.replace(".", "/")
    return path.with_suffix(".py").is_file() or (path / "__init__.py").is_file()


def test_the_reference_imports_nothing_of_the_program():
    """Every family's reference modules, as its module imports them."""
    mods = reference_modules()
    assert {f"perfbench.reference.{m}" for m in ("model", "mel", "rules", "special")} <= mods
    script = (f"import sys, {', '.join(sorted(mods))}; "
              "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('whisper_tpu_torch', 'whisper_tpu', 'jax')))")
    p = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr[-2000:]


def test_forbidden_names_are_compared_whole():
    from perfbench.run import FORBIDDEN

    assert "whisper_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "whisper_tpu.model".split(".")[0] in FORBIDDEN and "jax" in FORBIDDEN


def test_the_command_refuses_to_run_without_a_card():
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "large-v3.batch-int8", "--seed", "1", "--seconds", "10", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
