"""Import hygiene of the PyTorch port, in fresh interpreters.

The card's machine has no JAX, pandas or pyyaml.  Every module of
``wav2vecsegmenter_tpu_torch`` must import without jax, and the path that
``chip_smoke.py`` drives (cli.common, infer, models, data.windows, ops)
without pandas and yaml too; the JAX package's modules it reuses must be
its jax-free helpers.  Each check runs with the forbidden modules blocked.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""

# the jax-, pandas- and yaml-free modules of the JAX package the port reuses
REUSED = {
    "wav2vecsegmenter_tpu", "wav2vecsegmenter_tpu.algorithms",
    "wav2vecsegmenter_tpu.algorithms.pdac", "wav2vecsegmenter_tpu.algorithms.pthr",
    "wav2vecsegmenter_tpu.algorithms.segment",
    "wav2vecsegmenter_tpu.algorithms.strm", "wav2vecsegmenter_tpu.algorithms.tree",
    "wav2vecsegmenter_tpu.algorithms.yaml_out", "wav2vecsegmenter_tpu.constants",
    "wav2vecsegmenter_tpu.core", "wav2vecsegmenter_tpu.core.frames",
    "wav2vecsegmenter_tpu.core.windows", "wav2vecsegmenter_tpu.data",
    "wav2vecsegmenter_tpu.data.audio", "wav2vecsegmenter_tpu.data.collate",
}


def _run(code: str, blocked: set) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK.format(blocked=sorted(blocked)) + code],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_every_port_module_imports_without_jax():
    out = _run("""
import importlib, pkgutil
import wav2vecsegmenter_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names))
""", {"jax", "jaxlib"})
    assert int(out.split()[-1]) >= 15


@pytest.mark.parametrize("target", ["chip_smoke", "path"])
def test_chip_smoke_path_imports_no_jax_pandas_yaml(target):
    imports = ("import chip_smoke" if target == "chip_smoke" else
               "import wav2vecsegmenter_tpu_torch.cli.common, "
               "wav2vecsegmenter_tpu_torch.infer.pipeline, "
               "wav2vecsegmenter_tpu_torch.models.shas, "
               "wav2vecsegmenter_tpu_torch.data.windows, "
               "wav2vecsegmenter_tpu_torch.ops.layernorm, "
               "wav2vecsegmenter_tpu_torch.ops.attention")
    out = _run(imports + """
print(sorted(m for m in sys.modules if m.startswith("wav2vecsegmenter_tpu.")
             or m == "wav2vecsegmenter_tpu"))
""", {"jax", "jaxlib", "pandas", "yaml"})
    reused = set(eval(out.strip().splitlines()[-1]))
    assert reused and reused <= REUSED, reused - REUSED
