"""Synthetic segmentation-label pipeline (3 stages).

Behavioral contract: reference lib/prepare_synthetic_data.py:31-424.
  1. generate a pDAC binary segmentation tree per wav (tree yaml +
     tree.length);
  2. translate every tree node with an external fairseq ST model;
  3. bottom-up "tournament": a parent node is replaced by its children if
     their joined translation scores higher (sentence-BLEU precision gmean
     against the full-talk reference) — producing synthetic sentence-level
     segment labels, exported in MuST-C format and converted to
     talks/segments TSVs for SFC re-training.

Counterpart of ``wav2vecsegmenter_tpu/cli/prepare_synthetic_data.py``, with
its flags.  Stage 1 is the device path: a training run's checkpoint
(``<outputs>/<exp_name>/ckpts/<checkpoint>``, ``.pt`` added where the name
lacks it) loaded through ``cli.common.load_model`` runs
``infer.pipeline.WindowInference`` over whole talks on the card in bf16
(``--device cpu`` asks for the CPU, in float32), one talk dispatched ahead
of the one being drained; :func:`tree_rows` is that part, the yaml writing
follows it.  Stages 2-3 are host code behind the subprocess seam
(``fairseq-generate`` on ``PATH``); pyyaml, sacrebleu and scipy are
imported inside the functions that use them.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import time
from pathlib import Path

from ..algorithms import pdac_tree, update_tree_yaml_content
from ..data.windows import BatchIterator, FixedSegmentationDatasetNoTarget
from ..infer.pipeline import WindowInference, collect_talk, dispatch_talk
from ..stpipe.generation import format_generation_output
from ..stpipe.manifest import prepare_custom_dataset
from ..stpipe.mwer import run_mwer_segmenter
from ..stpipe.score import score_sacrebleu
from ..stpipe.xml import original_segmentation_to_xml


def tree_rows(model, wav_paths: list, device, compute_dtype,
              batch_size: int = 14, segment_length: float = 20,
              inference_times: int = 1, max_segment_length: float = 18,
              min_segment_length: float = 0.2,
              boundary_threshold: float = 0.5, trim_threshold: float = 0,
              tree_depth: int = 20, talk_probs: dict | None = None
              ) -> tuple[list[dict], list[tuple[str, int]]]:
    """Stage 1's device part: each talk's frame probabilities, averaged
    over ``inference_times`` passes, as the JAX ``generate_segmentation_tree``
    computes them (windows padded to ``batch_size``, one talk dispatched
    ahead of the one being drained), then its pDAC tree.  Returns the tree
    yaml rows and (wav name, tree length) per talk; ``talk_probs``, when
    given, receives each talk's averaged probabilities by wav name."""
    engine = WindowInference(model, device, compute_dtype)

    def dispatch_one(wav_path):
        dataset = FixedSegmentationDatasetNoTarget(
            wav_path, segment_length, inference_times)
        passes = []
        for it in range(inference_times):
            dataset.fixed_length_segmentation(it)
            batches = BatchIterator(
                dataset, batch_size, float(segment_length),
                remainder_ladder=False,
                pin_memory=engine.device.type == "cuda")
            passes.append(dispatch_talk(engine, batches))
        return Path(wav_path), dataset, passes

    yaml_content: list[dict] = []
    lengths: list[tuple[str, int]] = []
    handles = []
    wav_iter = iter(wav_paths)
    nxt = next(wav_iter, None)
    if nxt is not None:
        handles.append(dispatch_one(nxt))
    while handles:
        nxt = next(wav_iter, None)
        if nxt is not None:
            handles.append(dispatch_one(nxt))
        wav_path, dataset, passes = handles.pop(0)
        sgm_frame_probs = None
        for pending in passes:
            probs = collect_talk(pending, dataset.duration_outframes)
            sgm_frame_probs = probs if sgm_frame_probs is None else \
                sgm_frame_probs + probs
        sgm_frame_probs /= inference_times
        if talk_probs is not None:
            talk_probs[wav_path.name] = sgm_frame_probs.copy()

        tree = pdac_tree(
            sgm_frame_probs, max_segment_length, min_segment_length,
            boundary_threshold, trim_threshold, tree_depth,
        )
        lengths.append((wav_path.name, len(tree)))
        yaml_content = update_tree_yaml_content(
            yaml_content, tree, wav_path.name,
            max_segment_length, min_segment_length,
        )
    return yaml_content, lengths


def generate_segmentation_tree(args) -> None:
    import yaml

    from ..config import load_config, merge
    from .common import load_model

    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    train_config = load_config(Path(args.outputs) / ".hydra/config.yaml")
    train_config = merge(train_config, {"runtime": {
        "device": getattr(args, "device", "cuda")}})
    ckpt = Path(args.outputs) / train_config["exp_name"] / "ckpts" / \
        args.checkpoint
    if not ckpt.is_file() and ckpt.with_name(ckpt.name + ".pt").is_file():
        ckpt = ckpt.with_name(ckpt.name + ".pt")
    model, _, device, dtype = load_model(train_config, ckpt)

    rows, lengths = tree_rows(
        model, sorted(Path(args.path_to_wavs).glob("*.wav")), device, dtype,
        args.inference_batch_size, args.inference_segment_length,
        args.inference_times, args.max_segment_length,
        args.min_segment_length, args.boundary_threshold,
        args.trim_threshold, args.tree_depth)
    (save_dir / "tree.length").write_text(
        "".join(f"{name}\t{n}\n" for name, n in lengths))
    with open(save_dir / "custom_segments.tree.yaml", "w") as f:
        yaml.dump(rows, f, default_flow_style=True)


def generate_translation_tree(args) -> None:
    save_dir = Path(args.save_dir)
    tree_yaml = save_dir / "custom_segments.tree.yaml"
    prepare_custom_dataset(tree_yaml, args.path_to_wavs, args.tgt_lang, 0,
                           sort_by_offset=False)
    cmd = (
        f"fairseq-generate {save_dir}"
        " --task speech_text_joint_to_text --max-tokens 100000"
        " --max-source-positions 12000 --nbest 1 --batch-size 128"
        f" --path {args.path_to_st_checkpoint}"
        f" --gen-subset {tree_yaml.stem}"
        f" --config-yaml {Path(args.path_to_st_checkpoint).parent}/config.yaml"
        " --beam 5 --lenpen 1.0"
        f" --user-dir {args.fairseq_root}/examples/speech_text_joint_to_text"
        f" --load-speech-only > {save_dir}/translations.txt"
    )
    subprocess.run(cmd, shell=True, check=True)
    format_generation_output(save_dir / "translations.txt")


def _gmean_bleu(text: str, refs: list[str]) -> float:
    import sacrebleu
    from scipy.stats import gmean

    return float(gmean(sacrebleu.sentence_bleu(text, refs).precisions))


def tournament(metrics, depth, tgt_tree, tgt_segments, src_segments,
               ref_talks, out_segments, out_trans_segments, out_trans_talks):
    """Bottom-up parent-vs-children selection
    (reference lib/prepare_synthetic_data.py:170-256)."""
    for level in range(depth, 0, -1):
        for i in range(0, 2**level, 2):
            p_parent = 2 ** (level - 1) + i // 2 - 1
            p_a, p_b = 2**level + i - 1, 2**level + i
            child = " ".join([tgt_tree[p_a], tgt_tree[p_b]]).strip()
            if child == "":
                continue
            parent = tgt_tree[p_parent]
            promote = False
            if parent == "":
                promote = True
            else:
                if metrics != "BLEU":
                    raise NotImplementedError(metrics)
                promote = _gmean_bleu(child, ref_talks) > \
                    _gmean_bleu(parent, ref_talks)
            if promote:
                tgt_tree[p_parent] = child
                tgt_segments[p_parent] = tgt_segments[p_a] + tgt_segments[p_b]
                src_segments[p_parent] = src_segments[p_a] + src_segments[p_b]
            tgt_segments[p_a] = [""]
            tgt_segments[p_b] = [""]
            src_segments[p_a] = [{"offset": 10**20}]
            src_segments[p_b] = [{"offset": 10**20}]

    with open(out_trans_talks, "a") as f:
        f.write(tgt_tree[0] + "\n")
    with open(out_segments, "a") as fs, open(out_trans_segments, "a") as ft:
        srcs, tgts = src_segments[0], tgt_segments[0]
        idx = [i for i, _ in sorted(enumerate(srcs),
                                    key=lambda x: float(x[1]["offset"]))]
        for i in idx:
            if srcs[i] == {"offset": 10**20}:
                break
            fs.write(f"- {srcs[i]}\n")
            ft.write(tgts[i] + "\n")


def select_segments(args) -> None:
    import yaml

    save_dir = Path(args.save_dir)
    synthetic_dir = save_dir / "synthetic_data"
    synthetic_dir.mkdir(parents=True, exist_ok=True)

    tree_lengths = {}
    for line in (save_dir / "tree.length").read_text().splitlines():
        wav, length = line.split("\t")
        tree_lengths[wav] = int(length)

    with open(save_dir / "custom_segments.tree.yaml") as f:
        segmentation = yaml.safe_load(f)
    tgt_text = (save_dir / "translations_formatted.txt").read_text().splitlines()

    with open(args.path_to_src_yaml) as f:
        src_segmentation = yaml.safe_load(f)
    ref_texts = Path(args.path_to_ref_txt).read_text().splitlines()

    # full-talk references (reference :285-296)
    ref_talks: dict[str, list[str]] = {}
    pool: list[str] = []
    curr_wav = src_segmentation[0]["wav"]
    for i, seg in enumerate(src_segmentation):
        if seg["wav"] != curr_wav:
            ref_talks[curr_wav] = [" ".join(pool)]
            curr_wav = seg["wav"]
            pool = [ref_texts[i]]
        else:
            pool.append(ref_texts[i])
    ref_talks[curr_wav] = [" ".join(pool)]

    out_segments = synthetic_dir / "custom_segments.yaml"
    out_trans_segments = synthetic_dir / "translations_custom_segments.txt"
    out_trans_talks = synthetic_dir / "translations_talks.txt"
    for p in (out_segments, out_trans_segments, out_trans_talks):
        p.write_text("")

    def new_state(wav):
        n = tree_lengths[wav]
        return ([""] * n, [[""] for _ in range(n)],
                [[{"offset": 10**20}] for _ in range(n)])

    curr_wav = segmentation[0]["wav"]
    tgt_tree, tgt_segments, src_segments = new_state(curr_wav)
    depth = min(int(math.log2(len(tgt_tree))), args.tree_depth)
    for i, seg in enumerate(segmentation):
        if seg["wav"] != curr_wav:
            depth = min(int(math.log2(len(tgt_tree))), args.tree_depth)
            tournament(args.metrics, depth, tgt_tree, tgt_segments,
                       src_segments, ref_talks[curr_wav], out_segments,
                       out_trans_segments, out_trans_talks)
            print(f"tournament of {curr_wav} is completed")
            curr_wav = seg["wav"]
            tgt_tree, tgt_segments, src_segments = new_state(curr_wav)
        pos = int(seg["speaker_id"])
        tgt_tree[pos] = tgt_text[i]
        tgt_segments[pos] = [tgt_text[i]]
        src_segments[pos] = [seg]
    depth = min(int(math.log2(len(tgt_tree))), args.tree_depth)
    tournament(args.metrics, depth, tgt_tree, tgt_segments, src_segments,
               ref_talks[curr_wav], out_segments, out_trans_segments,
               out_trans_talks)
    print(f"tournament of {curr_wav} is completed")

    if args.evaluate_data:
        original_segmentation_to_xml(
            args.path_to_src_yaml, args.path_to_src_txt,
            args.path_to_ref_txt, save_dir,
        )
        split = Path(args.path_to_src_yaml).stem
        src_suffix = Path(args.path_to_src_txt).suffix
        ref_suffix = Path(args.path_to_ref_txt).suffix
        run_mwer_segmenter(
            save_dir / f"{split}{src_suffix}.xml",
            save_dir / f"{split}{ref_suffix}.xml",
            out_trans_segments,
            Path(args.path_to_st_checkpoint).parent.stem,
            args.tgt_lang,
            save_dir / "translations_aligned.xml",
            workdir=synthetic_dir,
            mwersegmenter_root=getattr(args, "mwersegmenter_root", None),
        )
        bleu = score_sacrebleu(
            str(synthetic_dir / "__mreference"),
            str(synthetic_dir / "__segments"),
        )
        (synthetic_dir / "score.sacrebleu").write_text(str(bleu))

    # MuST-C-format yaml + SFC-training TSVs (reference :370-388)
    with open(out_segments) as f:
        seg_rows = yaml.safe_load(f) or []
    with open(synthetic_dir / "custom_segments.mustc.yaml", "w") as f:
        for seg in seg_rows:
            f.write(f"- {str(seg).replace(chr(39), '')}\n")

    from ..data.prep import prepare_dataset_for_segmentation

    prepare_dataset_for_segmentation(
        synthetic_dir / "custom_segments.mustc.yaml",
        args.path_to_wavs, synthetic_dir, split="custom_segments.mustc",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stage", type=int, choices=range(1, 4), default=1)
    p.add_argument("--stop_stage", type=int, choices=range(1, 4), default=3)
    p.add_argument("--outputs", type=str)
    p.add_argument("--checkpoint", type=str)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--path_to_wavs", type=str)
    p.add_argument("--path_to_st_checkpoint", type=str)
    p.add_argument("--fairseq_root", type=str)
    p.add_argument("--mwersegmenter_root", type=str, default=None)
    p.add_argument("--tgt_lang", type=str, default="de")
    p.add_argument("--path_to_src_yaml", type=str)
    p.add_argument("--path_to_src_txt", type=str)
    p.add_argument("--path_to_ref_txt", type=str)
    p.add_argument("--inference_batch_size", type=int, default=14)
    p.add_argument("--inference_segment_length", type=float, default=20)
    p.add_argument("--inference_times", type=int, default=1)
    p.add_argument("--max_segment_length", type=float, default=18)
    p.add_argument("--min_segment_length", type=float, default=0.2)
    p.add_argument("--boundary_threshold", type=float, default=0.5)
    p.add_argument("--trim_threshold", type=float, default=0)
    p.add_argument("--tree_depth", type=int, default=20)
    p.add_argument("--metrics", type=str, default="BLEU")
    p.add_argument("--evaluate_data", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="stage 1's device: cuda (bf16) or cpu (float32)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    print(f"Stage {args.stage}-{args.stop_stage}")
    t_global = time.perf_counter()
    stage = args.stage
    while stage <= args.stop_stage:
        t0 = time.perf_counter()
        if stage == 1:
            print("Stage 1: generate segmentation tree")
            generate_segmentation_tree(args)
        elif stage == 2:
            print("Stage 2: generate translation tree")
            generate_translation_tree(args)
        elif stage == 3:
            print("Stage 3: select synthetic segments")
            select_segments(args)
        print(f"Stage {stage} finished (Elapsed: {time.perf_counter() - t0})")
        stage += 1
    print(f"All stages finished (Elapsed: {time.perf_counter() - t_global})")


if __name__ == "__main__":
    main()
