"""What a configuration file asks of a run besides its settings, set up
before anything imports the plain reference and undone when the run ends.

- ``"reference_modules": {"models.htdemucs": "references/<file>.py"}``:
  files under ``benchmarks/`` that stand in for single modules of the
  reference (``reference.<module>``), for a configuration whose plain
  reference differs from the shared one. Each is loaded in that module's
  place, so the check, the weight maker and the reference's batch runner
  all take it; like the rest of the reference it imports nothing of the
  program. The reference modules imported before are put back afterwards.
- ``"weights": {"<net>": {"seed": n, "widths": {...}}}``: the net's
  parameters made in set-up by the reference module's own ``init_params``
  (``widths`` are its arguments) from a ``torch.Generator`` on the run's
  device seeded with ``seed``, written with the reference's npz writer into
  the run's temporary directory, and ``<NET>_WEIGHTS`` pointed at the file,
  so the program and the check read the same bytes. The variables are put
  back as they were; the file goes with the temporary directory.

A configuration without either key, or whose ``weights`` is text (a note on
the checked-in checkpoints it reads, as ``mix.json``'s), runs with the
shared reference and the checked-in checkpoints."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import os
import sys
import time
from collections.abc import Iterator
from pathlib import Path

import torch


def _is_reference(name: str) -> bool:
    return name == "reference" or name.startswith("reference.")


@contextlib.contextmanager
def reference_modules(replacements: dict[str, str], root: Path) -> Iterator[None]:
    """``reference.<module>`` loaded from ``root/benchmarks/<file>`` for each
    entry, the reference imported afresh around them."""
    if not replacements:
        yield
        return
    bench = (root / "benchmarks").resolve()
    saved = {k: sys.modules.pop(k) for k in [k for k in sys.modules if _is_reference(k)]}
    try:
        for module, file in replacements.items():
            path = (bench / file).resolve()
            if not path.is_file() or not path.is_relative_to(bench):
                raise ValueError(f"reference module {module!r}: {file!r} is not a file under benchmarks/")
            name = f"reference.{module}"
            parent, _, leaf = name.rpartition(".")
            importlib.import_module(parent)
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
            setattr(sys.modules[parent], leaf, mod)
        yield
    finally:
        for k in [k for k in sys.modules if _is_reference(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def make_weights(net: str, entry: dict, path: Path, device: torch.device) -> None:
    """The parameters of ``net`` as its ``weights`` entry states them, written to ``path``."""
    from reference.models.params_io import save_pytree_npz

    init_params = importlib.import_module(f"reference.models.{net}").init_params
    generator = torch.Generator(device=device).manual_seed(int(entry["seed"]))
    save_pytree_npz(path, init_params(generator, **entry["widths"]))


@contextlib.contextmanager
def seeded_weights(weights: dict[str, dict], tmp: Path, device: torch.device) -> Iterator[list[str]]:
    """Each net's seeded file and its ``<NET>_WEIGHTS``; yields the ``run:`` lines that say what was made."""
    saved = {f"{net.upper()}_WEIGHTS": os.environ.get(f"{net.upper()}_WEIGHTS") for net in weights}
    lines = []
    try:
        for net, entry in weights.items():
            path = tmp / "weights" / f"{net}.npz"
            path.parent.mkdir(exist_ok=True)
            t = time.perf_counter()
            make_weights(net, entry, path, device)
            t = time.perf_counter() - t
            os.environ[f"{net.upper()}_WEIGHTS"] = str(path)
            lines.append(f"run: weights {net} from seed {entry['seed']}: {path.stat().st_size} bytes in {t:.3f} s")
        yield lines
    finally:
        for var, value in saved.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value


@contextlib.contextmanager
def configured(config: dict, root: Path, tmp: Path, device: torch.device) -> Iterator[list[str]]:
    """The configuration's reference modules, then its seeded weights; yields the ``run:`` lines."""
    weights = config.get("weights")
    with reference_modules(config.get("reference_modules", {}), root), \
            seeded_weights(weights if isinstance(weights, dict) else {}, tmp, device) as lines:
        yield lines
