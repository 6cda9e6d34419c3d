"""Time tile-shape variants of the bf16 FFN and conv kernels on one CUDA
card, side by side in one process.

    python3 -m wav2vecsegmenter_tpu_torch.ops.tile_sweep

Each variant is a copy of ``csrc/`` with its configuration lines replaced
(``using FfnWg = ...`` of ffn.cu; ``using ConvWgCfg = ...`` and
``kConvPersistent`` or ``using AudioTcCfg = ...`` and ``kAudioPersistent``
of convfuse.cu), built by nvcc (all at once) into its own library and
loaded with the same C signatures.  Every variant is held against the
plain version at the main path's shapes (bf16: the FFN at [14, 999, 1024]
x 4096, conv layer 1 at [14, 63999, 512], k=3, s=2, the raw-audio layer 0
at [14, 320000, 1], k=10, s=5), then timed in two rounds with CUDA events;
the FFN's two GEMM launches (bias + GELU, then bias) also get their device
times from torch.profiler.  Prints the card's name and power limit, then
one JSON line per variant and round; writes nothing.  A measurement tool:
nothing imports it.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

# WgGemm<BM, BN, STAGES> (wgmma_gemm.cuh): BM x BN tiles a warpgroup
FFN = {
    "128x128 s4": "WgGemm<128, 128, 4>",
    "128x128 s3": "WgGemm<128, 128, 3>",
    "128x128 s5": "WgGemm<128, 128, 5>",
    "64x128 s4": "WgGemm<64, 128, 4>",
    "128x64 s6": "WgGemm<128, 64, 6>",
}
# ConvWg<STAGES, CM, MC> (convfuse.cu): stages of 64 K-steps, clusters of
# CM row tiles x 2 channel halves (CM = 2 multicasts the weight's halves),
# MC: each CTA loads half of the A box and multicasts it to its partner;
# persistent grid, or one cluster a tile
CONV = {
    "s4 1x2 persistent": ("ConvWg<4, 1, false>", "true"),
    "s3 1x2 persistent": ("ConvWg<3, 1, false>", "true"),
    "s4 1x2 persistent, A multicast": ("ConvWg<4, 1, true>", "true"),
    "s4 2x2 persistent": ("ConvWg<4, 2, false>", "true"),
    "s4 1x2 a cluster a tile": ("ConvWg<4, 1, false>", "false"),
}
# AudioTc<STRIPS> (convfuse.cu): tiles of 16 * STRIPS rows; persistent
# grid, or one block a tile
AUDIO = {
    "64 rows persistent": ("AudioTc<4>", "true"),
    "64 rows a block a tile": ("AudioTc<4>", "false"),
    "32 rows persistent": ("AudioTc<2>", "true"),
}
# the lines of each kind's source that a variant replaces
PATTERNS = {
    "ffn": (r"using FfnWg = [^;]*;",),
    "conv": (r"using ConvWgCfg = [^;]*;",
             r"constexpr bool kConvPersistent = [^;]*;"),
    "audio": (r"using AudioTcCfg = [^;]*;",
              r"constexpr bool kAudioPersistent = [^;]*;"),
}


def _build_variants(work: Path) -> dict:
    from . import _build

    nvcc = _build._nvcc()
    jobs = {}
    for kind, variants, source in (("ffn", FFN, "ffn.cu"),
                                   ("conv", CONV, "convfuse.cu"),
                                   ("audio", AUDIO, "convfuse.cu")):
        for tag, decl in variants.items():
            d = work / f"{kind}_{len(jobs)}"
            shutil.copytree(_build.CSRC_DIR, d)
            text = (d / source).read_text()
            decls = (decl,) if isinstance(decl, str) else decl
            for pattern, value in zip(PATTERNS[kind], decls):
                head = pattern.split(" = ")[0]
                text, n = re.subn(pattern, f"{head} = {value};", text)
                if n != 1:
                    raise RuntimeError(f"no '{head}' line in {source}")
            (d / source).write_text(text)
            lib = d / "lib.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                   str(d / source), str(d / "layernorm.cu")]
            jobs[(kind, tag)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[key] = lib
    return libs


def main() -> int:
    import torch

    from . import convfuse, ffn
    from .timing import cuda_ms, device_ms

    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_variants(Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        rows, h, f = 14 * 999, 1024, 4096
        x = randn(14, 999, h).bfloat16()
        w1, b1 = randn(f, h, std=0.03).bfloat16(), randn(f, std=0.1)
        w2, b2 = randn(h, f, std=0.015).bfloat16(), randn(h, std=0.1)
        ref = ffn.ffn_plain(x, w1, b1, w2, b2)
        hidden = torch.empty(rows, f, dtype=x.dtype, device=dev)
        out = torch.empty_like(x)
        xc = randn(14, 63999, 512).bfloat16()
        wc = randn(512, 512, 3, std=1536 ** -0.5).bfloat16()
        cb, sc, bi = randn(512, std=0.3), 1 + randn(512, std=0.1), randn(
            512, std=0.1)
        wk = wc.permute(0, 2, 1).reshape(512, 1536).contiguous()
        ref_c = convfuse.conv_bias_ln_gelu_plain(xc, wc, cb, sc, bi, 2)
        out_c = torch.empty(14, 31999, 512, dtype=xc.dtype, device=dev)
        xa = randn(14, 320000, 1).bfloat16()
        wa = randn(512, 1, 10, std=10 ** -0.5).bfloat16()
        wak = wa.reshape(512, 10).contiguous()
        ref_a = convfuse.conv_bias_ln_gelu_plain(xa, wa, cb, sc, bi, 5)
        out_a = torch.empty(14, 63999, 512, dtype=xa.dtype, device=dev)
        calls = {
            "ffn": (lambda lib: lib.w2v_ffn(
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), hidden.data_ptr(), out.data_ptr(), rows, h, f,
                1, stream), out, ref, 4 * rows * h * f, 20),
            "conv": (lambda lib: lib.w2v_conv_ln_gelu(
                xc.data_ptr(), wk.data_ptr(), cb.data_ptr(), sc.data_ptr(),
                bi.data_ptr(), out_c.data_ptr(), 14, 63999, 512, 3, 2, 31999,
                512, 1e-5, 1, stream), out_c, ref_c,
                2 * 14 * 31999 * 1536 * 512, 10),
            "audio": (lambda lib: lib.w2v_conv_audio_ln_gelu(
                xa.data_ptr(), wak.data_ptr(), cb.data_ptr(), sc.data_ptr(),
                bi.data_ptr(), out_a.data_ptr(), 14, 320000, 1, 10, 5, 63999,
                512, 1e-5, 1, stream), out_a, ref_a,
                2 * 14 * 63999 * 10 * 512, 10),
        }
        for rnd in range(2):
            for (kind, tag), lib in libs.items():
                launch, got, want, flops, iters = calls[kind]
                status = launch(lib)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ms = cuda_ms(lambda: launch(lib), iters)
                # device ms of the FFN's first (GELU) and second GEMM
                split = ({f"{which}_gemm_ms": ms_ for which, ms_ in zip(
                    ("gelu", "bias"), device_ms(lambda: launch(lib), iters,
                                                ("true>", "false>")).values())}
                         if kind == "ffn" else {})
                print(json.dumps({"kernel": kind, "tile": tag, "round": rnd,
                                  "status": status, "max_abs_err": err,
                                  "ms": ms, "tflops": flops / ms / 1e9,
                                  **split}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
