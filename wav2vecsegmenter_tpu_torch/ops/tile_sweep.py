"""Time tile-shape variants of the bf16 FFN, conv and LayerNorm kernels on
one CUDA card, side by side in one process.

    python3 -m wav2vecsegmenter_tpu_torch.ops.tile_sweep [ffn conv audio ln]

Each variant is a copy of ``csrc/`` with its configuration lines replaced
(``using FfnWg = ...`` of ffn.cu; ``using ConvWgCfg = ...`` and
``kConvPersistent`` or ``using AudioTcCfg = ...`` and ``kAudioPersistent``
of convfuse.cu; ``using LnVecCfg = ...`` of layernorm.cu, and for the "no
gelu" probe the bf16 kernel's GELU line), built by nvcc (all at once) into
its own library and loaded with the same C signatures.  Every variant is
held against the plain version at the main path's shapes (bf16: the FFN
at [14, 999, 1024] x 4096, conv layer 1 at [14, 63999, 512], k=3, s=2, the
raw-audio layer 0 at [14, 320000, 1], k=10, s=5; the LayerNorm K1 at
[14 * 999, 1024] and [14 * 999, 512], and K2 at [14 * 63999, 512], the
probe against bias + LayerNorm without the GELU), then timed in two rounds
with CUDA events; the FFN's two GEMM launches (bias + GELU, then bias) and
the LayerNorm kernel also get their device times from torch.profiler, and
each LayerNorm shape one ``copy_`` of its bytes as a yardstick.
The arguments pick the kinds (all by default).  Prints the card's name and
power limit, then one JSON line per variant, shape and round; writes
nothing.  A measurement tool: nothing imports it.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
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
# LnVec<WARPS, DEPTH, MINB, PREFETCH> (layernorm.cu), set for K1 and K2
# alike: warps a CTA, rows in flight a warp, CTAs an SM the registers must
# allow, rows prefetched into L2 beyond those; then the variant's text
# patches: NO_GELU takes the bf16 kernel's GELU out (the "no gelu" split
# probe: K2's shape only), STORE_CS stores with the evict-first hint,
# LOAD_256B asks L2 to fetch 256-byte sectors
NO_GELU = (("if (GELU) y[j] = w2v_gelu(y[j]);", "(void)0;"),)
STORE_CS = (("*reinterpret_cast<uint4*>(outr + c0) = make_uint4(",
             "__stcs(reinterpret_cast<uint4*>(outr + c0), make_uint4("),
            ("w2v_pack_bf16(y[6], y[7]));", "w2v_pack_bf16(y[6], y[7])));"))
LOAD_256B = (("ld.global.nc.L1::no_allocate.v4.u32",
              "ld.global.nc.L1::no_allocate.L2::256B.v4.u32"),)
LN = {
    "8 warps, 1 row (K2's)": ("LnVec<8, 1, 1, 0>", ()),
    "4 warps, 2 rows (K1's)": ("LnVec<4, 2, 1, 0>", ()),
    "8 warps, 2 rows": ("LnVec<8, 2, 1, 0>", ()),
    "8 warps, 3 rows": ("LnVec<8, 3, 1, 0>", ()),
    "8 warps, 4 rows": ("LnVec<8, 4, 1, 0>", ()),
    "4 warps, 1 row": ("LnVec<4, 1, 1, 0>", ()),
    "2 warps, 2 rows": ("LnVec<2, 2, 1, 0>", ()),
    "16 warps, 2 rows": ("LnVec<16, 2, 1, 0>", ()),
    "8 warps, 2 rows, 2 CTAs an SM": ("LnVec<8, 2, 2, 0>", ()),
    "8 warps, 1 row, 3 CTAs an SM": ("LnVec<8, 1, 3, 0>", ()),
    "8 warps, 1 row, evict-first stores": ("LnVec<8, 1, 1, 0>", STORE_CS),
    "8 warps, 1 row, 256-byte L2 fetch": ("LnVec<8, 1, 1, 0>", LOAD_256B),
    "8 warps, 1 row, 2 rows prefetched": ("LnVec<8, 1, 1, 2>", ()),
    "4 warps, 2 rows, 2 rows prefetched": ("LnVec<4, 2, 1, 2>", ()),
    "8 warps, 1 row, no gelu": ("LnVec<8, 1, 1, 0>", NO_GELU),
    "8 warps, 1 row, 2 rows prefetched, no gelu": ("LnVec<8, 1, 1, 2>",
                                                  NO_GELU),
}
# the lines of each kind's source that a variant replaces
PATTERNS = {
    "ffn": (r"using FfnWg = [^;]*;",),
    "conv": (r"using ConvWgCfg = [^;]*;",
             r"constexpr bool kConvPersistent = [^;]*;"),
    "audio": (r"using AudioTcCfg = [^;]*;",
              r"constexpr bool kAudioPersistent = [^;]*;"),
    "ln": (r"using LnVecCfg = [^;]*;", r"using LnVecGeluCfg = [^;]*;"),
}
SOURCES = {"ffn": ("ffn.cu", FFN), "conv": ("convfuse.cu", CONV),
           "audio": ("convfuse.cu", AUDIO), "ln": ("layernorm.cu", LN)}


def _build_variants(work: Path, kinds) -> dict:
    from . import _build

    nvcc = _build._nvcc()
    jobs = {}
    for kind in kinds:
        source, variants = SOURCES[kind]
        for tag, decl in variants.items():
            d = work / f"{kind}_{len(jobs)}"
            shutil.copytree(_build.CSRC_DIR, d)
            text = (d / source).read_text()
            if kind == "ln":
                decl, patches = decl
                decl = (decl, decl)
                for before, after in patches:
                    if text.count(before) != 1:
                        raise RuntimeError(f"no '{before}' in {source}")
                    text = text.replace(before, after)
            decls = (decl,) if isinstance(decl, str) else decl
            for pattern, value in zip(PATTERNS[kind], decls):
                head = pattern.split(" = ")[0]
                text, n = re.subn(pattern, f"{head} = {value};", text)
                if n != 1:
                    raise RuntimeError(f"no '{head}' line in {source}")
            (d / source).write_text(text)
            lib = d / "lib.so"
            # layernorm.cu also carries w2v_error_string
            cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                   *dict.fromkeys([str(d / source), str(d / "layernorm.cu")])]
            jobs[(kind, tag)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        if key[0] == "ln":  # registers and spills of the bf16 kernels
            print(json.dumps({"kernel": "ln", "tile": key[1], "ptxas": [
                f"ln_vec_kernel {m[0].split('ln_vec_kernel')[1][:14]}: "
                f"{m[3]} registers, spills {m[1]}/{m[2]}"
                for m in re.findall(
                    r"entry function '(\w*ln_vec_kernel\w*)'[^\n]*\n"
                    r"(?:[^\n]*\n)*?[^\n]*?(\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads\n[^\n]*?Used (\d+) registers",
                    log)]}), flush=True)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[key] = lib
    return libs


def main() -> int:
    import torch

    from . import convfuse, ffn, layernorm
    from .timing import cuda_ms, device_ms

    kinds = sys.argv[1:] or list(SOURCES)
    if not set(kinds) <= set(SOURCES):
        raise SystemExit(f"tile_sweep: kinds are {list(SOURCES)}")
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

    # (label, launch(lib), output, reference, FLOP or None, iters, kernel
    # names for device times) by kind
    calls: dict = {}
    stream = torch.cuda.current_stream().cuda_stream
    cb, sc, bi = randn(512, std=0.3), 1 + randn(512, std=0.1), randn(
        512, std=0.1)
    if "ffn" in kinds:
        rows, h, f = 14 * 999, 1024, 4096
        x = randn(14, 999, h).bfloat16()
        w1, b1 = randn(f, h, std=0.03).bfloat16(), randn(f, std=0.1)
        w2, b2 = randn(h, f, std=0.015).bfloat16(), randn(h, std=0.1)
        hidden = torch.empty(rows, f, dtype=x.dtype, device=dev)
        out = torch.empty_like(x)
        calls["ffn"] = [("[14,999,1024]x4096", lambda lib: lib.w2v_ffn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), hidden.data_ptr(), out.data_ptr(), rows, h, f,
            1, stream), out, ffn.ffn_plain(x, w1, b1, w2, b2),
            4 * rows * h * f, 20, ("true>", "false>"))]
    if "conv" in kinds:
        xc = randn(14, 63999, 512).bfloat16()
        wc = randn(512, 512, 3, std=1536 ** -0.5).bfloat16()
        wk = wc.permute(0, 2, 1).reshape(512, 1536).contiguous()
        out_c = torch.empty(14, 31999, 512, dtype=xc.dtype, device=dev)
        calls["conv"] = [("[14,63999,512] k=3 s=2", lambda lib:
                          lib.w2v_conv_ln_gelu(
            xc.data_ptr(), wk.data_ptr(), cb.data_ptr(), sc.data_ptr(),
            bi.data_ptr(), out_c.data_ptr(), 14, 63999, 512, 3, 2, 31999,
            512, 1e-5, 1, stream), out_c,
            convfuse.conv_bias_ln_gelu_plain(xc, wc, cb, sc, bi, 2),
            2 * 14 * 31999 * 1536 * 512, 10, ())]
    if "audio" in kinds:
        xa = randn(14, 320000, 1).bfloat16()
        wa = randn(512, 1, 10, std=10 ** -0.5).bfloat16()
        wak = wa.reshape(512, 10).contiguous()
        out_a = torch.empty(14, 63999, 512, dtype=xa.dtype, device=dev)
        calls["audio"] = [("[14,320000,1] k=10 s=5", lambda lib:
                           lib.w2v_conv_audio_ln_gelu(
            xa.data_ptr(), wak.data_ptr(), cb.data_ptr(), sc.data_ptr(),
            bi.data_ptr(), out_a.data_ptr(), 14, 320000, 1, 10, 5, 63999,
            512, 1e-5, 1, stream), out_a,
            convfuse.conv_bias_ln_gelu_plain(xa, wa, cb, sc, bi, 5),
            2 * 14 * 63999 * 10 * 512, 10, ())]
    copies = []  # (label, a copy_ of the LayerNorm's bytes, iters)
    if "ln" in kinds:
        calls["ln"] = []
        for rows, h, gelu, iters in ((14 * 999, 1024, False, 50),
                                     (14 * 999, 512, False, 50),
                                     (14 * 63999, 512, True, 10)):
            xl = (randn(rows, h, std=2.0) + 0.5).bfloat16()
            s_, b_ = 1 + randn(h, std=0.1), randn(h, std=0.1)
            c_ = randn(h, std=0.3) if gelu else None
            out_l = torch.empty_like(xl)
            want = (layernorm.bias_layer_norm_gelu_plain(xl, c_, s_, b_)
                    if gelu else layernorm.layer_norm_plain(xl, s_, b_))
            # the "no gelu" probe's reference: bias + LayerNorm alone
            want_ln = (layernorm.layer_norm_plain(xl.float() + c_, s_, b_)
                       .bfloat16() if gelu else want)
            calls["ln"].append((f"[{rows},{h}]" + (" gelu" if gelu else ""),
                                lambda lib, xl=xl, s_=s_, b_=b_, c_=c_,
                                out_l=out_l, rows=rows, h=h, gelu=gelu:
                                lib.w2v_layer_norm(
                xl.data_ptr(), c_.data_ptr() if gelu else None,
                s_.data_ptr(), b_.data_ptr(), out_l.data_ptr(), rows, h,
                1e-5, 1, int(gelu), stream), out_l, (want, want_ln), None,
                iters, ("ln_vec_kernel",)))
            copies.append((calls["ln"][-1][0],
                           lambda xl=xl, out_l=out_l: out_l.copy_(xl), iters))

    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_variants(Path(tmp), kinds)
        for rnd in range(2):
            for (kind, tag), lib in libs.items():
                probe = kind == "ln" and LN[tag][1] == NO_GELU
                for label, launch, got, want, flops, iters, names in \
                        calls[kind]:
                    if probe and "gelu" not in label:
                        continue
                    if kind == "ln":
                        want = want[1] if probe else want[0]
                    status = launch(lib)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ms = cuda_ms(lambda: launch(lib), iters)
                    row = {"kernel": kind, "tile": tag, "shape": label,
                           "round": rnd, "status": status,
                           "max_abs_err": err, "ms": ms}
                    if flops is not None:
                        row["tflops"] = flops / ms / 1e9
                    if names:
                        dev_ms = device_ms(lambda: launch(lib), iters, names)
                        row["device_ms"] = (
                            dict(zip(("gelu_gemm_ms", "bias_gemm_ms"),
                                     dev_ms.values())) if kind == "ffn"
                            else sum(dev_ms.values()))
                    print(json.dumps(row), flush=True)
            # the yardstick of the LayerNorm rows: one copy of their bytes
            for label, copy, iters in copies:
                print(json.dumps({
                    "kernel": "ln", "tile": "copy_ of the same bytes",
                    "shape": label, "round": rnd, "ms": cuda_ms(copy, iters),
                    "device_ms": sum(device_ms(copy, iters,
                                               ("Memcpy DtoD",)).values())}),
                    flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
