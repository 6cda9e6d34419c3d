"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration,
traffic, limits and per-layer metrics in files of their own
(``benchlib.spec``).  The run builds the program (the PyTorch port,
``wav2vecsegmenter_tpu_torch``) and its inputs from the seed, warms up,
measures for ``--seconds``, then checks what the window produced against
the plain reference.  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiler trace of the window.  The last line of standard output
is the result as one JSON object; the numbers that decided ``correct``
close standard error.  Without a CUDA device, or with fewer devices than
the cell asks for, the run prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# modules whose presence after the window fails the run: the JAX package
# and JAX itself, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "wav2vecsegmenter_tpu")
# the program's build and kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
              "torch_extensions", "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "CUDA_CACHE_PATH": "cuda"}


def setup_environment() -> None:
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(BENCH_DIR / "_cache" / sub)
    # the interpreter's compiled modules, for installed packages too (a
    # read-only site-packages otherwise compiles them anew in every run)
    sys.pycache_prefix = str(BENCH_DIR / "_cache" / "pycache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (str(BENCH_DIR), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def context(cell, args, device, control: bool = False, bench_dir=BENCH_DIR):
    """What a driver gets: the cell's files, the run's arguments, the
    family's operation counts, and the hooks by which it reports the
    window's start and reads the device's memory peak."""
    import torch

    from benchlib import spec

    state = {"t_window": None}

    def window_started(t: float) -> None:
        state["t_window"] = t
        phase("window")

    def phase(name: str) -> None:
        """A line on standard error: the seconds since the process
        started at which the run reached ``name``."""
        print(f"phase {name}: {time.perf_counter() - T_START:.2f} s",
              file=sys.stderr, flush=True)

    def memory_peak() -> int:
        return torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0

    @contextlib.contextmanager
    def float32():
        """Float32 products in float32, not TF32, for the reference."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    family = spec.load_module(Path(bench_dir) / "flops"
                              / f"{cell.config['family']}.py",
                              f"bench_flops_{cell.config['family']}")
    # a traced run measures a shorter window: reading its trace takes
    # some ten times the window
    window_seconds = min(args.seconds, cell.traffic["trace_seconds"]) \
        if args.trace else args.seconds
    return types.SimpleNamespace(
        cell=cell, config=cell.config, traffic=cell.traffic,
        limits=cell.limits, seed=args.seed, seconds=args.seconds,
        window_seconds=window_seconds,
        trace=args.trace, device=device, control=control, family=family,
        window_started=window_started, phase=phase, memory_peak=memory_peak,
        float32=float32, state=state)


def result(cell, args, out: dict, device, t_window: float,
           bench_dir=BENCH_DIR) -> dict:
    """The result line of a finished run (``out``: the driver's)."""
    import torch

    from benchlib import spec

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], bench_dir)(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {name: {"value": value, "unit": units[name]}
                   for name, value in out["e2e"].items()}
        metrics["setup_s"] = {"value": t_window - T_START, "unit": "s"}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(out["memory_peak"])}
    line = {"correct": out["checks"].correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["window_s"]
        line["breakdown"] = out["breakdown"]
    if out["checks"].info:
        line["info"] = out["checks"].info
    line["checks"] = out["checks"].table()
    return line


def main(argv=None, device=None, spec_data=None, bench_dir=BENCH_DIR,
         control: bool = False):
    """Run a cell; returns the result line (None where the run must not
    report).  ``device``, ``spec_data`` and ``bench_dir`` are for the
    benchmark's own CPU tests: a CPU device skips the look for a card,
    ``spec_data`` stands for ``BENCHMARK.json`` and ``bench_dir`` for
    this directory's data files.  ``control`` runs the cell's control
    (``readings.py``) in place of the program where the driver has one."""
    args = parse(argv)
    setup_environment()
    import torch

    from benchlib import spec

    cell = spec.resolve(args.workload, spec_data, Path(bench_dir))
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"error: the cell {cell.name} needs {cell.chips} CUDA "
                  "device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return None
        device = torch.device("cuda", 0)
    ctx = context(cell, args, torch.device(device), control, bench_dir)
    out = spec.driver(cell, Path(bench_dir)).run(ctx)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return None
    line = result(cell, args, out, ctx.device, ctx.state["t_window"],
                  bench_dir)
    for text in out["checks"].lines():
        print(text, file=sys.stderr)
    return line


if __name__ == "__main__":
    line = main()
    if line is None:
        sys.exit(2)
    print(json.dumps(line), flush=True)
