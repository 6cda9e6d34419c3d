"""The operation and byte counts against hand counts at the configurations'
widths."""

from __future__ import annotations

import copy
import json

import pytest

from benchlib import spec

BENCH = spec.BENCH_DIR
FLOPS = spec.load_module(BENCH / "flops" / "wav2vec2.py", "flops_wav2vec2")
LNA = json.loads((BENCH / "configs" / "shas-xlsr300m-l24-lna.json")
                 .read_text())
# the product task's model: the same widths, the backbone kept to its first
# 15 layers and frozen (conf/task/shas.yaml)
L15 = copy.deepcopy(LNA)
L15["task"].update(wav2vec_keep_layers=15, finetune_wav2vec=False)
WINDOW = 320000   # a 20 s window


def test_conv_lengths():
    assert FLOPS.conv_lengths(WINDOW, L15) == [63999, 31999, 15999, 7999,
                                                3999, 1999, 999]


def test_l15_window_is_575_gflop():
    # by hand: the conv stack (layer 0: 63999 x 512 x 10 x 2; layers 1-4:
    # t x 512 x 512 x 3 x 2; layers 5-6: x 2 taps), the projection 512 ->
    # 1024, the positional conv (64 inputs a channel, 128 taps), 15 layers
    # of QKV 3h^2, out h^2, FFN 2hf and attention 2 t h over 999 frames,
    # the head at F = 2048
    t, h = 999, 1024
    conv = 2 * 63999 * 512 * 10 + sum(2 * n * 512 * 512 * 3 for n in
                                      (31999, 15999, 7999, 3999)) \
        + sum(2 * n * 512 * 512 * 2 for n in (1999, 999))
    layer = 2 * t * (3 * h * h + h * h + 2 * h * 4096) + 4 * t * t * h
    head = 2 * t * (3 * h * h + h * h + 2 * h * 2048) + 4 * t * t * h \
        + 2 * t * h
    hand = conv + 2 * t * 512 * h + 2 * t * h * 64 * 128 + 15 * layer + head
    got = FLOPS.window_forward_flops(WINDOW, L15)
    assert got == pytest.approx(hand, rel=1e-12)
    assert got == pytest.approx(575e9, rel=0.01)


def test_train_step_counts():
    fwd = FLOPS.window_forward_flops(WINDOW, LNA)
    lna = FLOPS.train_step_flops(4, WINDOW, LNA)
    assert lna == pytest.approx(7.6e12, rel=0.03)
    assert lna > 4 * 2 * fwd
    head = FLOPS.train_step_flops(14, WINDOW, L15)
    t = 999
    assert head == pytest.approx(
        14 * (FLOPS.window_forward_flops(WINDOW, L15)
              + 2 * FLOPS.head_flops(t, L15)), rel=1e-12)


def test_kernel_costs():
    ops, nbytes = FLOPS.attention_cost([999, 500], 16, 64)
    assert ops == 4 * (999 ** 2 + 500 ** 2) * 16 * 64
    assert nbytes == 2 * 4 * (999 + 500) * 16 * 64
    ops_b, _ = FLOPS.attention_cost([999], 16, 64, backward=True)
    assert ops_b == 2 * FLOPS.attention_cost([999], 16, 64)[0]
