"""End-to-end ST evaluation: segment -> translate -> align -> score.

Orchestration mirrors reference train.py:36-212 (eval_st) and
inference_st_pipe.py:53-214: the segmentation yaml is converted into a
fairseq dataset, translated by an external ``fairseq-generate`` (subprocess
seam preserved), realigned to the reference segmentation with the mWER
resegmenter, and scored with sacreBLEU / BERTScore / BLEURT.

The port's copy of ``wav2vecsegmenter_tpu/stpipe/eval_st.py``, pyyaml
imported inside :func:`eval_st`
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import logging
import subprocess
from pathlib import Path

from ..config import Config, to_plain
from .generation import format_generation_output
from .manifest import prepare_custom_dataset
from .mwer import run_mwer_segmenter
from .score import score_bertscore, score_bleurt, score_sacrebleu
from .xml import original_segmentation_to_xml

logger = logging.getLogger("wav2vecsegmenter_tpu_torch")


def fairseq_generate_cmd(
    infer_config: Config, results_path: Path, style: str = "train"
) -> str:
    """Build the fairseq-generate command line.

    ``style="train"`` reproduces the in-training eval command (reference
    train.py:130-148: always the joint-s2t task, with
    ``--skip-invalid-size-inputs-valid-test``).  ``style="cli"`` reproduces
    the standalone ST-pipe entry (reference inference_st_pipe.py:96-124),
    which dispatches on the ST model directory's basename and rejects
    unknown models.
    """
    if style == "cli":
        st_base = Path(str(infer_config.st_model_dir)).name
        if st_base == "joint-s2t-mustc-en-de":
            return (
                f"fairseq-generate {results_path}"
                " --task speech_text_joint_to_text"
                " --max-tokens 100000"
                " --max-source-positions 12000"
                " --nbest 1"
                " --batch-size 128"
                f" --path {infer_config.st_model_dir}/{infer_config.st_ckpt}"
                f" --gen-subset {Path(infer_config.cust_seg_yaml).stem}"
                f" --config-yaml {infer_config.st_model_dir}/config.yaml"
                " --beam 5"
                " --lenpen 1.0"
                f" --user-dir {infer_config.fairseq_root}/examples/speech_text_joint_to_text"
                f" --load-speech-only > {results_path}/translations.txt"
            )
        if st_base == "mustc_multilingual_st":
            return (
                f"fairseq-generate {results_path}"
                " --task speech_to_text"
                f" --path {infer_config.st_model_dir}/{infer_config.st_ckpt}"
                f" --gen-subset {Path(infer_config.cust_seg_yaml).stem}"
                f" --config-yaml {infer_config.st_model_dir}/config.yaml"
                " --max-tokens 50000"
                " --beam 5"
                f" --prefix-size 1 > {results_path}/translations.txt"
            )
        raise ValueError("Unknown model dir")
    return (
        f"fairseq-generate {results_path}"
        " --task speech_text_joint_to_text"
        " --max-tokens 100000"
        " --max-source-positions 12000"
        " --nbest 1"
        " --batch-size 128"
        f" --path {infer_config.st_model_dir}/{infer_config.st_ckpt}"
        f" --gen-subset {Path(infer_config.cust_seg_yaml).stem}"
        f" --config-yaml {infer_config.st_model_dir}/config.yaml"
        " --beam 5"
        " --lenpen 1.0"
        " --skip-invalid-size-inputs-valid-test"
        f" --user-dir {infer_config.fairseq_root}/examples/speech_text_joint_to_text"
        f" --load-speech-only > {results_path}/translations.txt"
    )


def eval_st(
    infer_config: Config,
    yaml_content: list[dict],
    results_path: Path,
    algorithm: str,
    cmd_style: str = "train",
) -> dict:
    """Run translate+align+score for an already-generated segmentation.

    Returns a results dict with the reference's metric keys
    (eval_st_bleu_{algo} etc., train.py:119-210)."""
    import yaml

    results: dict = {}
    results_path = Path(results_path)
    results_path.mkdir(parents=True, exist_ok=True)

    cust_seg_yaml = results_path / infer_config.cust_seg_yaml
    with open(cust_seg_yaml, "w") as f:
        yaml.dump(yaml_content, f, default_flow_style=True)
    results[f"eval_st_n_segments_{algorithm}"] = len(yaml_content)

    prepare_custom_dataset(
        cust_seg_yaml,
        infer_config.infer_data.wav_dir,
        infer_config.infer_data.tgt_lang,
        0,
    )

    cmd = fairseq_generate_cmd(infer_config, results_path, style=cmd_style)
    logger.info("Running: %s", cmd)
    proc = subprocess.run(cmd, shell=True)
    if proc.returncode != 0 or not (results_path / "translations.txt").exists():
        logger.warning(
            "fairseq-generate unavailable or failed (rc=%s) — skipping "
            "translation scoring", proc.returncode)
        return results

    format_generation_output(results_path / "translations.txt")

    original_segmentation_to_xml(
        infer_config.infer_data.orig_seg_yaml,
        infer_config.infer_data.orig_src_txt,
        infer_config.infer_data.orig_tgt_txt,
        results_path,
    )

    split_name = Path(infer_config.infer_data.orig_seg_yaml).stem
    sysid = Path(infer_config.st_model_dir).stem
    src_lang = infer_config.infer_data.src_lang
    tgt_lang = infer_config.infer_data.tgt_lang
    mref, segs = None, None
    segs, mref = run_mwer_segmenter(
        results_path / f"{split_name}.{src_lang}.xml",
        results_path / f"{split_name}.{tgt_lang}.xml",
        results_path / "translations_formatted.txt",
        sysid, tgt_lang,
        results_path / "translations_aligned.xml",
        workdir=results_path,
        mwersegmenter_root=infer_config.get("mwersegmenter_root"),
    )

    st_metrics = to_plain(infer_config.get("st_metrics", ["bleu"]))
    if "bleu" in st_metrics:
        bleu = score_sacrebleu(str(mref), str(segs))
        (results_path / "score.sacrebleu").write_text(str(bleu))
        results[f"eval_st_bleu_{algorithm}"] = bleu.score
    if "bertscore" in st_metrics:
        try:
            p, r, f1 = score_bertscore(str(mref), str(segs), tgt_lang)
            (results_path / "score.bertscore").write_text(
                f"BERTScore (P/R/F1) = {p:.4f}/{r:.4f}/{f1:.4f}")
            results[f"eval_st_bertscore_p_{algorithm}"] = p
            results[f"eval_st_bertscore_r_{algorithm}"] = r
            results[f"eval_st_bertscore_f1_{algorithm}"] = f1
        except RuntimeError as e:
            logger.warning("%s", e)
    if "bleurt" in st_metrics:
        try:
            b = score_bleurt(str(mref), str(segs),
                             str(infer_config.bleurt_path))
            (results_path / "score.bleurt").write_text(
                f"BLEURT (Average) = {b:.4f}")
            results[f"eval_st_bleurt_{algorithm}"] = b
        except RuntimeError as e:
            logger.warning("%s", e)

    return results
