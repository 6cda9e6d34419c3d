"""Nothing under benchmark/ imports JAX or the JAX package: the top-level
module name (the part before the first dot) compared whole, since the
port's name, ``wav2vecsegmenter_tpu_torch``, begins with the JAX
package's."""

from __future__ import annotations

import ast
import importlib
import importlib.abc
import sys
from pathlib import Path

import pytest

import run
from benchlib import spec

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "wav2vecsegmenter_tpu"}


def sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "_cache" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_import_names_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"{name} is blocked")
        return None


def test_modules_import_with_jax_blocked(monkeypatch):
    monkeypatch.setattr(sys, "meta_path", [_Block()] + sys.meta_path)
    for name in [m for m in list(sys.modules)
                 if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    for path in sources():
        rel = path.relative_to(BENCH).with_suffix("")
        if rel.parts[0] == "tests":
            continue
        if rel.parts[0] in ("benchlib", "reference"):   # packages
            importlib.import_module(".".join(rel.parts))
        else:
            spec.load_module(path, "guard_" + "_".join(rel.parts)
                             .replace(".", "_"))
    import wav2vecsegmenter_tpu_torch.cli.common  # noqa: F401 the port too
    assert not run.forbidden_modules()


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "wav2vecsegmenter_tpu_torch_extra",
                        sys.modules[__name__])
    assert "wav2vecsegmenter_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "wav2vecsegmenter_tpu.models",
                        sys.modules[__name__])
    assert run.forbidden_modules() == ["wav2vecsegmenter_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        sys.modules[__name__])
    assert "jaxlib" in run.forbidden_modules()


def test_run_refuses_without_a_card(monkeypatch, capsys):
    """The command itself fails without a card: no result, exit code 2."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "xlsr24-lna.train-b4", "--seed", "1",
                     "--seconds", "1"]) is None
    assert "needs 1 CUDA" in capsys.readouterr().err
