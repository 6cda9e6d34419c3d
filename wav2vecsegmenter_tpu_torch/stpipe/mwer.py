"""mWER resegmentation driver.

Runs the native C++ resegmenter (native/mwer) with the same CLI contract as
the original segmentBasedOnMWER.sh the reference invokes
(inference_st_pipe.py:140-148): outputs ``__segments`` / ``__mreference`` in
the working directory plus the aligned XML.  If the config points
``mwersegmenter_root`` at an original mwerSegmenter install, that is used
instead (drop-in compatibility both ways).

The port's counterpart of ``wav2vecsegmenter_tpu/stpipe/mwer.py``: the
binary is built from ``native/mwer/mwer_segmenter.cpp`` into the port's
``_build/`` (``data.native_audio.build_native``, native/mwer/Makefile's
flags), never by ``make`` in ``native/mwer``.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

from ..data.native_audio import NATIVE_DIR as _NATIVE_ROOT
from ..data.native_audio import build_native

NATIVE_DIR = _NATIVE_ROOT / "mwer"
MWER_FLAGS = ("-O2", "-std=c++17", "-Wall")


def _ensure_native_built() -> Path:
    """The resegmenter's binary, built on first use."""
    return build_native("mwer_segmenter", ("mwer/mwer_segmenter.cpp",),
                        MWER_FLAGS)


def run_mwer_segmenter(
    src_xml: str | Path,
    ref_xml: str | Path,
    hyp_txt: str | Path,
    sysid: str,
    tgt_lang: str,
    out_xml: str | Path,
    workdir: str | Path,
    mwersegmenter_root: str | None = None,
    normalize: bool = True,
    usecase: int = 1,
) -> tuple[Path, Path]:
    """Returns (path to __segments, path to __mreference)."""
    workdir = Path(workdir)
    if mwersegmenter_root and (
        Path(mwersegmenter_root) / "segmentBasedOnMWER.sh"
    ).exists() and Path(mwersegmenter_root) != NATIVE_DIR:
        cmd = [
            str(Path(mwersegmenter_root) / "segmentBasedOnMWER.sh"),
            str(src_xml), str(ref_xml), str(hyp_txt), sysid, tgt_lang,
            str(out_xml), "normalize" if normalize else "no-normalize",
            str(usecase),
        ]
    else:
        binary = _ensure_native_built()
        cmd = [
            str(binary), str(src_xml), str(ref_xml), str(hyp_txt), sysid,
            tgt_lang, str(out_xml),
            "normalize" if normalize else "no-normalize", str(usecase),
        ]
    subprocess.run(cmd, cwd=workdir, check=True)
    return workdir / "__segments", workdir / "__mreference"
