"""Model families: the parts of the harness that are one model's own.

A configuration file (``perfbench/configs/<config>.json``) names its family
under ``"family"``, ``whisper`` where it names none. The family is the
module ``<DIR>/<family>.py``, loaded by its path, and exposes:

  ``dims(config) -> dict``
      the sizes, from the file's published keys;
  ``draw(dims, seed, dtype, device) -> dict``
      the weight tree from the seed (``perfbench.weights.draw``), in the
      layout the program reads;
  ``build(dims, tree, cell, device) -> (engine, options)``
      the served program, from the cell's ``engine`` block: the engine
      that ``EngineServer`` drives and the server's options;
  ``readings(picked, tree, dims, audio_of, device, control) -> dict``
      the comparison of the requests ``picked`` (``check.sample``) with the
      family's plain reference: every key of the cell's ``check.limits``
      but ``unanswered`` (the harness counts that), and ``requests``,
      ``windows`` and ``tokens``; with ``control``, the control's numbers in
      the program's place and the program's own ``program_max_gap``.

A family's reference lives in modules of its own under
``perfbench/reference/`` (plain float32 torch with TF32 off, importing
nothing of the program); its operation and byte counts live in modules of
its own, which its metric readers (``perfbench/metrics/<metric>.py``)
import. A new model is added by new files and new ``BENCHMARK.json``
entries alone.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType

DIR = Path(__file__).resolve().parent
DEFAULT = "whisper"
_NAME = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")


def load(name: str) -> ModuleType:
    """``<DIR>/<name>.py``, loaded by its path."""
    if not _NAME.match(name):
        raise ValueError(f"family {name!r} is not a name")
    path = DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"family {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_family_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def of(config: dict) -> ModuleType:
    """The family a configuration file names."""
    return load(config.get("family", DEFAULT))
