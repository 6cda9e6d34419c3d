"""Import hygiene of the PyTorch port, in fresh interpreters.

The port keeps its own copies of what it needs and imports nothing of the
JAX package; the card's machine has no JAX, pandas, pyyaml, optax, tqdm,
scikit-learn or soundfile.  Every module of ``wav2vecsegmenter_tpu_torch``
and ``chip_smoke.py`` must import with those blocked (pyyaml is imported
inside the functions that read yaml, which the card's path never calls),
and load no module of the JAX package.
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

BLOCKED = {"wav2vecsegmenter_tpu", "jax", "jaxlib", "pandas", "yaml", "optax",
           "tqdm", "sklearn", "soundfile"}


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
""", BLOCKED)
    assert int(out.split()[-1]) >= 40


@pytest.mark.parametrize("target", ["chip_smoke", "path"])
def test_chip_smoke_path_imports_no_jax_pandas_yaml(target):
    imports = ("import chip_smoke" if target == "chip_smoke" else
               "import wav2vecsegmenter_tpu_torch.cli.common, "
               "wav2vecsegmenter_tpu_torch.cli.segment, "
               "wav2vecsegmenter_tpu_torch.cli.inference, "
               "wav2vecsegmenter_tpu_torch.checkpoints.io, "
               "wav2vecsegmenter_tpu_torch.infer.pipeline, "
               "wav2vecsegmenter_tpu_torch.infer.packing, "
               "wav2vecsegmenter_tpu_torch.infer.online, "
               "wav2vecsegmenter_tpu_torch.infer.server, "
               "wav2vecsegmenter_tpu_torch.cli.online, "
               "wav2vecsegmenter_tpu_torch.cli.serve, "
               "wav2vecsegmenter_tpu_torch.models.shas, "
               "wav2vecsegmenter_tpu_torch.models.autoreg, "
               "wav2vecsegmenter_tpu_torch.data.windows, "
               "wav2vecsegmenter_tpu_torch.ops.layernorm, "
               "wav2vecsegmenter_tpu_torch.ops.attention, "
               "wav2vecsegmenter_tpu_torch.ops.ffn, "
               "wav2vecsegmenter_tpu_torch.ops.convfuse, "
               "wav2vecsegmenter_tpu_torch.ops.quant, "
               "wav2vecsegmenter_tpu_torch.cli.train, "
               "wav2vecsegmenter_tpu_torch.train.loop, "
               "wav2vecsegmenter_tpu_torch.train.step, "
               "wav2vecsegmenter_tpu_torch.train.loss, "
               "wav2vecsegmenter_tpu_torch.data.datasets, "
               "wav2vecsegmenter_tpu_torch.data.loader, "
               "wav2vecsegmenter_tpu_torch.data.vocab, "
               "wav2vecsegmenter_tpu_torch.eval.metrics, "
               "wav2vecsegmenter_tpu_torch.ops.rowdot, "
               "wav2vecsegmenter_tpu_torch.cli.prepare_synthetic_data, "
               "wav2vecsegmenter_tpu_torch.cli.inference_st_pipe, "
               "wav2vecsegmenter_tpu_torch.core.runtime, "
               "wav2vecsegmenter_tpu_torch.core.trace, "
               "wav2vecsegmenter_tpu_torch.core.wandblog, "
               "wav2vecsegmenter_tpu_torch.parallel.mesh, "
               "wav2vecsegmenter_tpu_torch.ops.shmap")
    out = _run(imports + """
print(sorted(m for m in sys.modules if m.split(".")[0] in %r))
""" % sorted(BLOCKED), BLOCKED)
    assert eval(out.strip().splitlines()[-1]) == []
