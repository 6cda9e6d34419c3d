"""mteval XML generation for mWER alignment.

Behavioral contract: reference lib/eval_scripts/original_segmentation_to_xml.py
(:7-120) — srcset/refset documents per talk, one <seg> per corpus-text line,
empty src/tgt pairs dropped.

The port's copy of ``wav2vecsegmenter_tpu/stpipe/xml.py``, pyyaml imported
inside :func:`original_segmentation_to_xml`
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

from pathlib import Path


def create_xml_content(segmentation, lang_text, split, src_lang, tgt_lang,
                       is_src: bool) -> list[str]:
    xml = ['<?xml version="1.0" encoding="UTF-8"?>', "<mteval>"]
    if is_src:
        xml.append(f'<srcset setid="{split}" srclang="{src_lang}">')
    else:
        xml.append(
            f'<refset setid="{split}" srclang="{src_lang}" '
            f'trglang="{tgt_lang}" refid="ref">'
        )
    prev_talk_id = None
    seg_id = 0
    for sgm, txt in zip(segmentation, lang_text):
        talk_id = sgm["wav"].split(".wav")[0]
        if prev_talk_id != talk_id:
            if prev_talk_id is not None:
                xml.append("</doc>")
            xml.append(f'<doc docid="{talk_id}" genre="lectures">')
            xml.append("<keywords>does, not, matter</keywords>")
            xml.append("<speaker>Someone Someoneson</speaker>")
            xml.append(f"<talkid>{talk_id}</talkid>")
            xml.append("<description>Blah blah blah.</description>")
            xml.append("<title>Title</title>")
            seg_id = 0
            prev_talk_id = talk_id
        seg_id += 1
        xml.append(f'<seg id="{seg_id}">{txt}</seg>')
    xml.append("</doc>")
    xml.append("</srcset>" if is_src else "</refset>")
    xml.append("</mteval>")
    return xml


def original_segmentation_to_xml(path_to_yaml, path_to_src_txt,
                                 path_to_tgt_txt, path_to_output):
    """corpus yaml + transcript/translation txts -> {split}.{lang}.xml pair."""
    import yaml

    split = Path(path_to_yaml).stem
    src_lang = Path(path_to_src_txt).suffix
    tgt_lang = Path(path_to_tgt_txt).suffix
    path_to_output = Path(path_to_output)

    with open(path_to_yaml) as f:
        segmentation = yaml.safe_load(f)
    with open(path_to_src_txt) as f:
        src_text = f.read().splitlines()
    with open(path_to_tgt_txt) as f:
        tgt_text = f.read().splitlines()

    src_clean, tgt_clean = [], []
    for s, t in zip(src_text, tgt_text):
        if s and t:
            src_clean.append(s)
            tgt_clean.append(t)

    out_paths = []
    for text, lang, is_src in ((src_clean, src_lang, True),
                               (tgt_clean, tgt_lang, False)):
        if not is_src and src_lang == tgt_lang:
            break
        content = create_xml_content(segmentation, text, split, src_lang,
                                     tgt_lang, is_src)
        path = path_to_output / f"{split}{lang}.xml"
        with open(path, "w", encoding="UTF-8") as f:
            f.write("\n".join(content) + "\n")
        out_paths.append(path)
    return out_paths
