"""Vocabularies of the SSL/CTC and cross-entropy task variants.

Contract follows reference lib/datautils.py:12-54: four special tokens
(<B> boundary, <NB> non-boundary, <PAD>, <SEP>), optionally extended by the
wav2vec2 CTC character vocabulary offset by the special-token count.

The reference fetches the char vocab from the HF hub at import time
(lib/datautils.py:7-9); here the standard 32-symbol vocab of
facebook/wav2vec2-large-960h-lv60-self is embedded statically (it is fixed
for all official wav2vec2 English CTC checkpoints), with an optional override
from a local ``vocab.json``.

The port's copy of ``wav2vecsegmenter_tpu/data/vocab.py``
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import json
from pathlib import Path

# vocab.json of facebook/wav2vec2-large-960h-lv60-self (and -960h, -base-960h)
WAV2VEC2_CTC_CHAR_VOCAB: dict[str, int] = {
    "<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4,
    "E": 5, "T": 6, "A": 7, "O": 8, "N": 9, "I": 10, "H": 11, "S": 12,
    "R": 13, "D": 14, "L": 15, "U": 16, "M": 17, "W": 18, "C": 19, "F": 20,
    "G": 21, "Y": 22, "P": 23, "B": 24, "V": 25, "K": 26, "'": 27, "X": 28,
    "J": 29, "Q": 30, "Z": 31,
}


class BaseVocabulary:
    """4-token vocabulary (reference lib/datautils.py:12-38)."""

    def __init__(self):
        self.word2id = {
            "<B>": 0,
            "<NB>": 1,
            "<PAD>": 2,
            "<SEP>": 3,
        }
        self.n_special_tokens = len(self.word2id)
        self.set_properties()

    def set_properties(self):
        self.id2word = {v: k for k, v in self.word2id.items()}
        self.boundary_token = self.id2word[0]
        self.boundary_token_id = self.word2id["<B>"]
        self.nonboundary_token = self.id2word[1]
        self.nonboundary_token_id = self.word2id["<NB>"]
        self.pad_token = self.id2word[2]
        self.pad_token_id = self.word2id["<PAD>"]
        self.sep_token = self.id2word[3]
        self.sep_token_id = self.word2id["<SEP>"]
        self.vocab_size = len(self.word2id)

    def get_vocab(self):
        return self.word2id


class UppercasedCharVocabulary(BaseVocabulary):
    """Special tokens + CTC char vocab offset by 4
    (reference lib/datautils.py:41-54)."""

    def __init__(self, vocab_json: str | None = None):
        super().__init__()
        if vocab_json and Path(vocab_json).exists():
            with open(vocab_json) as f:
                char_vocab = json.load(f)
        else:
            char_vocab = dict(WAV2VEC2_CTC_CHAR_VOCAB)
        for k in char_vocab:
            char_vocab[k] += self.n_special_tokens
        self.word2id = {**self.word2id, **char_vocab}
        self.set_properties()
        self.unk_token_id = self.word2id["<unk>"]
        self.word_delimiter_id = self.word2id["|"]

    def encode_transcript(self, text: str) -> list[int]:
        """Uppercased characters -> vocabulary ids (offset by the special
        tokens), spaces mapped to the wav2vec2 word delimiter '|' and
        unknown characters to <unk> — the tgt_text encoding for the CTC
        task the reference planned but never wired
        (reference lib/dataset.py:45 '[TODO] load self.tgt_text')."""
        ids = []
        for ch in " ".join(text.upper().split()):
            if ch == " ":
                ids.append(self.word_delimiter_id)
            else:
                ids.append(self.word2id.get(ch, self.unk_token_id))
        return ids
