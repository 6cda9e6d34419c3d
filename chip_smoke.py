"""Smoke run of the PyTorch port (wav2vecsegmenter_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each printed on its own line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the kernels of wav2vecsegmenter_tpu_torch/ops/csrc
   (one process per source file, in parallel); the line carries ptxas's
   registers and spills of every kernel (the bf16 conv and LayerNorm
   kernels and the float32 layer-0 kernel must show none: checked after
   the kernel phase);
3. kernels: each hand kernel against its plain PyTorch version on the card,
   at the shapes the segmentation and training paths give it, float32
   (TF32 off) and bf16, with ragged lengths; times from CUDA events,
   beside the kernel's bound (the larger of its bytes over 3.35 TB/s and
   its operations over the peak rate of their type) and, where one PyTorch
   call computes the same function, that call's time (for the attention backward: the SDPA call's forward +
   backward less its forward); each output is held to the tolerances of
   its own dtype.  Every attention row (K3, K4 and K10, both dtypes,
   every head dim and cross shape) is timed three times in turns with its
   SDPA call, the median on record.  The bf16 attention backward rows
   first run the forward under grad, whose softmax statistics are held
   against their plain
   version, and add the forward's time with and without them and the
   profiler's device time of each of K10's three kernels; the FFN rows
   (the full batch, the tail bucket and the remainder ladder's 1, 2 and 4
   windows) add the cuBLAS chain linear -> GELU -> linear as a reference
   time and the device time of the two GEMM launches; the conv rows
   (layers 0-6 of a batch) run twice, bitwise, are timed three times (the
   median on record) and add the cuDNN chain conv1d -> layer_norm -> gelu
   as a reference time and the device time of the conv kernels; the
   LayerNorm rows (K1 at h = 1024 and 512, the tail bucket's rows and a
   width with a masked tail; K2 at conv layers 0, 1 and 6's outputs) run
   twice, bitwise, are timed three times (K1 in turns with F.layer_norm)
   and add the profiler's device time of the kernel and, for K1, of
   F.layer_norm and both calls' host time a call; the LayerNorm backward
   (K9: h = 1024 and, last, A4's 512, the masked-tail width and the
   variant without dx) runs twice, bitwise, is timed three times against
   its library call, in turns, and adds the profiler's device time of each
   of its kernels and of the library call; last, K1 and K3-K7 in bf16 at
   the online path's shapes: one window, a slot of eight, and one window
   holding 0.5 s of audio (a stream's final flush: padding zero, the
   attention's keys all masked but 24); last, K4 and K10 at the arseg
   decoder's cross-attention geometry (queries of 1000 and 64 rows over
   999 keys, 8 heads of 128, both dtypes, ragged keys); last, the bce
   head's output layer (C18: the row-local kernel of ops/csrc/rowdot.cu
   at 14 x 999 rows of 1024, both dtypes, beside cuBLAS's F.linear; in
   bf16 bitwise the kernel order's plain rendering, ``row_dot_ordered``,
   and in both a window's rows alone bitwise as in the batch); last, K4
   at the base models' SFC head (8 heads of D=96, [14, 999], both
   dtypes, ragged keys and an all-masked row, beside SDPA); last, K10 at
   D=96: the head's [14, 999, 8, 96] and a cross row at arseg's base
   geometry (1000 queries over 999 keys), both dtypes, ragged keys and an
   all-masked row, twice (bitwise), beside SDPA's forward + backward less
   its forward;
4. slice: a full-width SHAS (xls-r-300m geometry, 15 encoder layers, SFC
   1 x 8 heads, seeded random weights, output layer x40) segments two
   synthetic talks through cli.common.segment_wavs at batch 14 in bf16 with
   pTHR, in the default configuration (fused conv layers and FFN): once
   through the kernels (launch counters reset just before), once eager
   (counters must not move), once in float32; then once in the JAX
   package's A/B configuration W2VSEG_CONVFUSE=0 W2VSEG_FFNFUSE=0 through
   the kernels (counters reset just before; the path of the conv epilogue
   kernel).  The kernels' bf16 probabilities must be as close to the
   float32 ones as the eager path's (within KERNEL_SLACK), the kernels and
   eager no further apart than bf16 is from float32, the two
   configurations within BF16_PAIR of their distance to float32, six
   conv_bias_ln_gelu launches (layers 1-6) to each conv_audio_ln_gelu,
   34 layer_norm launches a batch in both configurations and 7
   bias_layer_norm_gelu launches a batch in the unfused one; the line
   carries each batch's read + collate ms in the reader;
5. batch: one full batch of 14 x 20 s windows timed in both configurations
   with the kernels, and eager, in turns (``--profile`` adds torch.profiler
   tables of one batch in each configuration on standard error);
6. precision: the same batch through each arm of the precision ladder
   (``runtime.precision`` bf16, f32head, f32res, f32last4, f32) with the
   kernels, against the eager float32 path: mean, p99 and max |dprob|, the
   batch's wall and device busy ms, its launches (every arm launches what
   the default path does); the f32 arm within F32_ATOL of the eager float32
   path (mean and p99), f32res's mean |dprob| below bf16's; and C3's
   trace: for the bf16 kernels and bf16 eager paths, the relative L2
   error from float32 of each conv layer's output, of the hidden state
   after the feature projection, after each encoder layer and of the
   head's logits;
7. int8: ``runtime.quantize=int8`` on the same batch, at the bf16 and
   f32res arms, with the kernels: mean, p99 and max |dprob| against the
   eager float32 path, the bf16 path and the int8 eager path (the
   kernels' distance to float32 within KERNEL_SLACK of the int8 eager
   path's), its launches (the default path's less the fused FFN, which
   int8 weights bypass), the int8 and bf16 batches' wall ms in turns and
   device busy ms, a profiled int8 batch's device time split into
   ``_int_mm``, quantization, dequantization and the rest, the four
   products alone at the batch's shapes (``_int_mm`` against the bf16
   matmul, the int8 layer against the bf16 ``F.linear``, each beside its
   bound at the int8 and bf16 peaks; the int32 sums held exact), and one
   2 min stream at batch 1, int8 and bf16 (it must commit);
8. packing: ``runtime.pack_across_talks`` through cli.common.segment_wavs
   at batch 14 on five talks, packed and per talk in turns: batches
   (fewer packed) and wall; against the batch-size deviation class (the
   per-talk sweep at batches 1 and 3, and at 14 without the remainder
   ladder, against 14), each talk's max |dprob| within 1.5 times that
   envelope (tests/test_packing.py's bound) and the yaml rows no further
   from the per-talk sweep's than those sweeps' rows (rows beyond
   tests/test_packing.py's offset and duration bounds, a talk's row
   count); every window scattered back (asserted inside the packer);
9. online: online serving in bf16 with the kernels (launch counters reset
   just before, read just after; K1, K3-K7 must launch): the first calls at
   slots of 1, 2, 4 and 8 windows; one 60 s stream at batch 1 (pTHR,
   tumbling and with a 2 s hop): each window's wall, device ms a window
   (profiled run), audio-s per wall-s; eight concurrent 60 s streams
   through MultiStreamSegmenter (max_batch 8, 0.5 s chunks): audio-s per
   wall-s, batch sizes, device busy ms and idle share of a profiled run;
   batch invariance: every window batched in 8 slots against the same
   window alone (max |dprob|, bitwise-equal rows), the boundaries the
   multiplexed streams commit against each stream alone, and each op of
   the path on 8 windows against the first alone; a SegmentationServer on
   a localhost port (pSTRM) with eight client threads, each connection's
   segments against its stream alone at batch 1 (as many boundaries apart
   as two for each frame within the invariance figure of the threshold),
   then a connection still streaming at shutdown drained to its end line;
   asserted (C18): the output layer's rows alone bitwise as batched, every
   window's probabilities batched bitwise as alone, and the multiplexed
   streams' commits equal to each stream's alone;
10. train: the same full-width SHAS trains its SFC head on a frozen backbone
   through the port's loop (``train.loop.train``) on a synthetic corpus
   written to a temporary directory, batch 14, 20 s windows,
   update_freq=2, two epochs of three micro-steps (a full accumulation and
   an epoch-end flush each): bf16 through the kernels (launch counters
   reset just before; the path of the backward kernels K9 and K10, and
   K9 without dx on the head's first LayerNorm, whose input is the frozen
   backbone's), bf16
   eager (counters must not move), float32 through the kernels and
   float32 eager, from the same weights and generator seed.  Checked:
   finite losses, the backbone bitwise unchanged, the head moved, the
   kernels' bf16 first-micro-step head gradients as close to the float32
   ones as the eager bf16 gradients (within KERNEL_SLACK), and the
   float32 kernels and eager gradients within F32_GRAD.  The bf16 kernels
   run keeps checkpoints as a run does (an eval and a checkpoint every
   three micro-steps and at each epoch's end, keep_last_ckpts=1, the best
   by eval_f1): the files on disk, the run state's bookkeeping and the
   newest checkpoint loaded through load_reference_checkpoint are checked.
   The line gives the micro-step's wall, its fetch (the wait on the
   background reader) and its read (the reader's own read + collate);
   ``steady_state`` the same over a 40-talk epoch of 18 micro-steps in
   three runs: the reader on the native loader (``native``), the reader
   on the stdlib ``wave`` route (``wave``, forced by ``wave_reader``) and
   the serial builder (``serial``), each with its ms a micro-step while
   the reads go on and once they are done, read and fetch ms, and device
   busy ms and idle share over four profiled micro-steps in mid-epoch;
   a fifth run, bf16 with the kernels, profiles one micro-step for the
   device's busy time (``--profile``: its torch.profiler table on
   standard error);
11. resume: the train phase's bf16 kernels run twice uninterrupted (their
   losses' and grad_norms' relative spread is the bf16 path's run-to-run
   spread), then stopped in its second epoch's first micro-step and
   resumed from its run state (``resume=true``): the resumed epoch's
   losses and grad_norms within that spread of the uninterrupted run's,
   every train kernel launched in the resumed run;
12. lna: LNA fine-tuning (``finetune_wav2vec=True``) through the port's loop:
   (d) first, the autograd Functions whose backward replays a composition
   (K5, K6 at conv layer 1, K7 at layer 0, K2 at layer 0's output; a
   14 x 20 s batch's shapes): forward under grad through the kernel, then
   the backward; gradients against autograd through the plain version
   (float32 within F32_GRAD, bf16 as close to float32 as the Function with
   the plain forward, within KERNEL_SLACK), times of both forwards and
   backwards; the positional conv's forward and backward (cuDNN) timed at
   batch 4 and 14, with cuDNN's heuristics and autotuned; (a) the
   README's recipe (xls-r-300m, 24 layers, all
   fine-tuned, no adapters, FFNs and feature encoder frozen, SFC 1 x 8
   heads, seeded random weights) on two synthetic talks, batch 4,
   update_freq=2, two epochs of three micro-steps, four runs from the same
   weights and seed (bf16 / float32, kernels / eager; the launch counters
   reset before each, eager must not move them): finite losses, every
   frozen parameter bitwise unchanged and every trained one moved, each
   kernels micro-step's launches equal to ``lna_launches``, the
   first-micro-step gradients as in the train phase; (e) the bf16 kernels
   run's final checkpoint (full layout) loaded back strictly and
   segmenting one talk; (f) the reader's cost at batch 4: the bf16
   kernels run of (a) for one epoch over the train phase's corpus (nine
   micro-steps), with the reader, the serial builder twice and the reader
   again, launches checked, the median wall of a micro-step and
   of the last two (the reader done) and the read ms of each arm; (b) the
   same as (a) at the reference batch 14 on the
   train phase's corpus; (a) and (b) report the wall, fetch and read ms of
   a micro-step, the fetch's share, peak memory, and one micro-step's
   device time and top ops from torch.profiler; (c) conf/task/shas.yaml's
   adapters with the top 8 of 15 layers, their FFNs and the feature
   encoder fine-tuned: one epoch of two micro-steps, layers 0-6 bitwise
   unchanged, adapters in layers 7-14 only and moved, the conv stack
   moved, each micro-step's launches checked;
13. ssl: the multi-class heads. SHASWithSSL at the lv60-self width (24
   layers, its final encoder LayerNorm on K1, a CTC lm_head of 32, a
   36-way SFC head; seeded random weights, the output layer x4 and <B>'s
   bias raised by its median gap to the other logits' maximum on the full
   batch) saved in the reference's SSL full layout and loaded through
   the inference CLIs' loader (cli.common.load_model, task=shas_ssl);
   the slice's two talks through cli.common.segment_wavs at batch 14 with
   algorithm=dac_logits and dac, kernels (launch counters reset just
   before the dac_logits run; each kernel's launches a batch checked) and
   eager (counters must not move): segment counts, the boundaries that
   differ, the walls of dac_logits and dac in turns; one full batch in
   bf16 with the kernels and eager against the float32 plain path: mean,
   p99 and max |dprob| of p(<B>), the CTC logits' deviation (the kernels'
   within KERNEL_SLACK of the plain path's for both), the share of frames
   whose 36-way and CTC argmax agree; the batch's wall ms (kernels and
   eager in turns), device busy ms, the top device ops of one profiled
   batch, launches and peak memory; then three
   micro-steps of task=shas_ssl (frozen backbone, batch 14, pseudo-labels
   from the CTC head) and three of task=shas_ctc (xls-r-300m at 15
   layers fine-tuned on a corpus whose segments.tsv carries tgt_text,
   batch 4) through the port's loop, each in three arms (bf16 kernels,
   bf16 eager, float32 eager): finite losses, the path's kernels launched
   (K9/K10 among them), the first micro-step's gradients as in the train
   phase, ms a micro-step and peak memory;
14. arseg: the autoregressive segmenter (task=arseg) at the xls-r-300m
   width (15 layers, a 1-layer encoder and a 4-layer decoder of 8 heads,
   FFN 2048, V=4; seeded random weights, the <B>/<NB> rows of the output
   layer x4 and <NB>'s bias centred on the float32 decode's median gap)
   saved as the port's full-layout .pt and loaded through
   cli.common.load_model: the slice's two talks through
   cli.common.segment_wavs at batch 14 with pTHR (bf16 kernels, the
   launch counters reset just before; bf16 eager, counters unmoved;
   float32): segments, |dprob| against float32, walls; one full batch's
   KV-cached greedy decode: launches a batch checked (K1 34 + 13 a decode
   step, K3 15, K4 1, K5 15, K6 6, K7 1), walls of the three arms in
   turns, device busy ms, the encode's ms and a decode step's wall, peak
   memory, the free-running tokens' agreement with float32, the float32
   gap's percentiles; the teacher-forced forward fed the float32 decode's
   tokens (the kernels' bf16 logits as close to float32 as the eager
   path's, within KERNEL_SLACK; the float32 forward equal to the float32
   decode); then three micro-steps of train.step.make_train_step (frozen
   backbone, batch 14) in three arms (bf16 kernels / bf16 eager /
   float32): finite losses, the backbone bitwise unchanged and the head
   moved, each kernels micro-step's launches (K4 5, K10 5, K9 16 of
   which 1 without dx), the first gradients as in the train phase, ms a
   micro-step, device busy ms, peak memory;
15. st (after the online phase and the train phase): (a) the
   synthetic-data tool's stage 1 device part (cli.prepare_synthetic_data.
   tree_rows) on the slice's two talks at batch 14, inference_times 1
   and 2, bf16 with the kernels, bf16 eager and float32: the slice
   phase's rules on the averaged probabilities, every talk's tree, the
   rows and tree lengths, walls, audio-s per wall-s and launches; (b) the
   in-training ST evaluation's device part (train.loop.st_eval_segments)
   with the train phase's live model at batch 1 for pDAC and pTHR: the
   model back in train mode, the trainer's generator unmoved, the rows
   equal to segment_wavs's on the trainer's final.pt loaded fresh, the
   wall.  The host part (eval_st, mWER, sacreBLEU, pyyaml) is not run on
   the card: tier-1 holds it;
16. base: the base models' geometry (``facebook/wav2vec2-base``: 12
   post-LN layers of 768, 12 heads of 64, the group-norm conv stack without
   conv bias, which no conv kernel takes; SFC 1 x 8 heads of D=96; seeded
   random weights, output layer x40): the slice's two talks through
   cli.common.segment_wavs at batch 14 with pTHR, bf16 kernels (launch
   counters reset just before; K1 28, K3 12, K5 12, K4 1, row_dot 1 a
   batch, no conv kernel), bf16 eager (counters unmoved) and float32: the
   slice's |dprob| rules, the kernels' yaml rows against eager's within
   tests/test_packing.py's bounds; one full batch of 14 x 20 s, kernels
   and eager in turns: wall ms, device busy ms and idle share, the conv
   stack's plain group route alone, mean and p99 |dprob| against the eager
   float32 batch (the kernels within KERNEL_SLACK of eager), the batch's
   launches; reported: a window alone bitwise as in a batch of 8 or not;
17. base_train: training at the base width (facebook/wav2vec2-base: 12
   post-LN layers of 768, the SFC head at D=96, seeded weights) through
   train.loop.train on the train phase's synthetic corpus, the launch
   counters reset before each run and each micro-step's launches checked:
   (a) the head on a frozen backbone, batch 14, two epochs of three
   micro-steps (K10 1, K4 1, K9 3 of which 1 without dx, K1 28, K3 12,
   no conv kernel, and no K5: the base models' activation dropout takes
   the FFN to its two GEMMs in train mode); (b) LNA, every layer
   fine-tuned, FFNs and the feature encoder frozen, at batch 14 and
   batch 4, each two epochs of
   three micro-steps in four arms (bf16 and float32, kernels and eager):
   finite losses, frozen parameters bitwise unchanged, trained ones moved
   (the unapplied encoder.layer_norm by weight decay alone: its gradient
   is 0, and its zero bias stays), K10 13 (12 at D=64, the head's at
   D=96), the first gradients within KERNEL_SLACK of eager's distance to
   float32, float32 kernels within F32_GRAD of eager; (c) one epoch of
   conf/task/shas.yaml's default (adapters, not applied on a post-LN
   layer) with the feature encoder trained: the group-norm stack and the
   adapters move; (d) three micro-steps each of shas_ssl (base-960h,
   frozen, batch 14), shas_ctc (fine-tuned, batch 4) and arseg (frozen,
   batch 14; K4 and K10 5, at D=96); (e) one arseg decode batch through
   segment_wavs (bf16 kernels) with its launches.  Reported: ms a
   micro-step, device busy ms of a profiled micro-step and its wall,
   peak memory;
18. mesh (parallel.mesh, ops.shmap, core.runtime, core.trace) at the
   slice's width (xls-r-300m, 15 layers, the SFC head; seed 0) on the
   slice's two talks: (a) world size 1 over NCCL (a group of one rank
   joined through W2VSEG_COORDINATOR): runtime.mesh data=1 and the
   default -1 make no mesh, and the segment run's rows and three frozen
   micro-steps (losses and gradients) equal the run without a group,
   bitwise; (b) two ranks on the one card over gloo (NCCL refuses two
   ranks on one device), launched by core.runtime.launch_ranks: data
   parallel (data=2, 7 rows a rank of batch 14, each rank reading only
   its rows: every rank's windows read must equal its rows of the sweep's
   batches, with its read ms a batch and its reader route) and tensor
   parallel
   (model=2: K3 at 8 heads, K5 at F=2048, the head's K4 at 4 heads): each
   run's probabilities within KERNEL_SLACK of the one-rank bf16 run's
   distance to float32 (mean and p99), the data-parallel yaml rows
   within tests/test_packing.py's bounds of the one-rank run's; one
   micro-step of conf/task/shas.yaml's LNA split under model=2 (K9 and
   K10 on the shards, adapters split too): the first gradients, joined
   whole, within KERNEL_SLACK of the one-rank bf16 step's relative L2
   distance to float32 eager; one FSDP step (data=2) where gloo carries
   it on CUDA tensors (its loss within MESH_LOSS_RTOL of the one-rank
   step's), else the refusal recorded; each rank's ms a batch under both
   meshes and the all-reduce share of a TP batch (gloo's all-reduces go
   through the host); the TP runs' launches (every kernel of the path
   must launch) go to the kernels line as ``launches_mesh``; (c) a train
   run with runtime.profile_steps=2 leaves a torch.profiler trace under
   profile/ whose CUDA kernels include the port's (attn_fwd_tc_kernel,
   ffn_wg_kernel, ln_vec_kernel);
19. the script's seconds; a JSON line of every kernel (launches on the
   LNA recipe's run, or for K2 the unfused slice's, for the output layer's
   kernel the slice's, and on the online,
   ssl, arseg, base, base_train and mesh phases; error, times, bound, and the
   float32 route's row; K5/K6/K7/K2 add their Function row; K4 and K10
   add their D=96 rows under ``d96``, K10 its D=96 cross row under
   ``d96_cross``), the nvidia-smi line, and the
   last line: {"ok": true, "device": {...}}.

The kernel phase runs each backward kernel twice on the same inputs: the
outputs must be bitwise equal (no atomics).  The attention rows (bf16 on
the tensor-core kernels, float32 on the scalar ones) include a batch row
whose keys are all masked, compared in full: its outputs must also be the
uniform average of its in-range values.

Every phase that reads wavs (slice, packing, online, train, lna, mesh)
prints ``reader_backend`` (``data.audio.reader_backend``) and fails
unless the native loader reads them.

Needs CUDA; exits non-zero without it.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from wav2vecsegmenter_tpu_torch.cli.common import segment_wavs
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy
from wav2vecsegmenter_tpu_torch.ops import _build, backend
from wav2vecsegmenter_tpu_torch.ops import attention as attn
from wav2vecsegmenter_tpu_torch.ops import convfuse as conv
from wav2vecsegmenter_tpu_torch.ops import ffn as tffn
from wav2vecsegmenter_tpu_torch.ops import layernorm as ln
from wav2vecsegmenter_tpu_torch.ops import rowdot
from wav2vecsegmenter_tpu_torch.ops.timing import (cuda_ms, device_ms,
                                                    device_busy_ms, host_us)

B = 14              # conf/segment.yaml batch_size
T, T_TAIL = 999, 1099   # frames of a 20 s window and of the 22 s tail bucket
L_AUDIO = 320000    # samples of a 20 s window
T_CONV0 = (L_AUDIO - 10) // 5 + 1  # frames of conv layer 0's output
# float32 (TF32 off in PyTorch): summation order, and in the attention
# kernels split-TF32 products (three TF32 products a product, ~2^-22 of it)
F32_ATOL = 1e-4
BF16_ATOL = 2 ** -5  # one bf16 step at |y| in [4, 8): independent roundings
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): memory, bf16, int8
# and TF32 tensor cores, float32 outside the tensor cores (the scalar
# kernels' arithmetic)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16_tc": 989e12, "int8_tc": 1979e12, "tf32_tc": 495e12,
            "f32": 67e12}
# the float32 attention kernels (K3, K4, K10), the float32 FFN (K5) and the
# float32 conv layers 1-6 (K6) take each product as three TF32 products on
# the tensor cores (split TF32): their bound counts the products three
# times at the TF32 peak
SPLIT_TF32 = 3
# scalar operations an element of a LayerNorm (mean, variance, normalise,
# scale, bias), of its backward (the statistics again, x-hat, g*scale, the
# two row means, dx, the two column sums) and of a GELU (erf counted as
# one) take
LN_OPS, LN_BWD_OPS, GELU_OPS = 8, 14, 4
# the backward kernels' sums (over ~14k rows for dscale/dbias, ~1k keys or
# queries for dq/dk/dv) run in other orders than the plain versions':
# relative slack on top of the absolute tolerances, by the output's dtype
# (a bf16 output: one bf16 step of the value, where the float32 sum rounds
# to either side; dscale and dbias are float32 in both arms)
BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# the bf16 forward's softmax statistics under grad, (m, l) of a query row,
# against their plain version: float32 sums of the same terms in another
# order (m is up to a few tens in log2 units; l a sum of up to T terms)
STATS_ATOL, STATS_RTOL = 1e-4, 1e-4
# float32 train arm: the kernels' and the eager path's first-micro-step
# head gradients, relative L2 distance
F32_GRAD = 1e-4
# conf/algorithm/pthr.yaml
PTHR = {"tag": "pthr", "max_segment_length": 28, "min_segment_length": 0.2,
        "max_lerp_range": 4, "min_lerp_range": 0.4, "threshold": 0.1,
        "moving_average_window": 0.1}
# The bf16 envelope the JAX package measured on a TPU against float32
# (PARITY.md: mean 2.7e-3, p99 0.055).  Reported, not asserted: PyTorch
# rounds to bf16 after every op where XLA rounds once per fusion, and two
# bf16 runs that differ only in summation order part to the bf16 noise
# floor through 15 layers.  Asserted instead: the kernels add no error to
# the bf16 path (their distance to the float32 run is within KERNEL_SLACK of
# the plain path's), and the kernels and the plain path, which round at the
# same points, differ by no more than bf16 differs from float32.
JAX_ENVELOPE = {"mean": 3e-3, "p99": 0.055}
KERNEL_SLACK = 1.25
# Two bf16 paths that round at different points each sit at about the
# bf16-vs-float32 distance d from the float32 run, with independent noise,
# so about sqrt(2) d from each other: the bound between the default and the
# unfused configuration.
BF16_PAIR = 2 ** 0.5
# the JAX package's A/B arm (the unfused configuration): conv layers as
# GEMMs + the bias -> LayerNorm -> GELU kernel, the FFN as GEMMs around a
# GELU
UNFUSED = {"W2VSEG_CONVFUSE": "0", "W2VSEG_FFNFUSE": "0"}

CSRC = "wav2vecsegmenter_tpu_torch/ops/csrc/"
SOURCES = {  # kernel: (source, the TPU kernel it replaces)
    "layer_norm": (CSRC + "layernorm.cu",
                   "wav2vecsegmenter_tpu/ops/layernorm.py:34"),
    "bias_layer_norm_gelu": (CSRC + "layernorm.cu",
                             "wav2vecsegmenter_tpu/ops/layernorm.py:195"),
    "attention_packed": (CSRC + "attention.cu",
                         "wav2vecsegmenter_tpu/ops/attention.py:327"),
    "attention_bthd": (CSRC + "attention.cu",
                       "wav2vecsegmenter_tpu/ops/attention.py:89"),
    "ffn": (CSRC + "ffn.cu", "wav2vecsegmenter_tpu/ops/ffn.py:73"),
    "conv_bias_ln_gelu": (CSRC + "convfuse.cu",
                          "wav2vecsegmenter_tpu/ops/convfuse.py:127 "
                          "(and :100, :161)"),
    "conv_audio_ln_gelu": (CSRC + "convfuse.cu",
                           "wav2vecsegmenter_tpu/ops/convfuse.py:161"),
    "layer_norm_bwd": (CSRC + "layernorm_bwd.cu",
                       "wav2vecsegmenter_tpu/ops/layernorm.py:42"),
    "attention_bwd": (CSRC + "attention_bwd.cu",
                      "wav2vecsegmenter_tpu/ops/attention.py:111"),
    # no TPU kernel: the JAX head's output layer is an XLA dot; the kernel
    # repairs ROADMAP C18 (a window's logit hung on its batch)
    "row_dot": (CSRC + "rowdot.cu",
                "wav2vecsegmenter_tpu/models/sfc.py:133 (an XLA dot; C18)"),
}
# kernels of the default configuration's path; bias_layer_norm_gelu runs on
# the A/B arm's
DEFAULT_PATH = ("layer_norm", "attention_packed", "attention_bthd", "ffn",
                "conv_bias_ln_gelu", "conv_audio_ln_gelu")
UNFUSED_PATH = ("layer_norm", "attention_packed", "attention_bthd",
                "bias_layer_norm_gelu")
# the trainer's path: the default configuration's forward kernels and the
# head's backward kernels
TRAIN_PATH = DEFAULT_PATH + ("layer_norm_bwd", "attention_bwd")
# the inference paths of the bce head also run its output layer through
# the row-local kernel (C18); under grad it stays a matmul
INFER_PATH = DEFAULT_PATH + ("row_dot",)
# conv layers 2-5 of a 14 x 20 s batch (t_in, k, s); layers 1 and 6 have
# rows of their own, as has the raw-audio layer 0
CONV_MIDDLE = ((31999, 3, 2), (15999, 3, 2), (7999, 3, 2), (3999, 2, 2))
# the conv kernels by name (bf16: wgmma + TMA, tensor-core taps; float32:
# the raw-audio layer 0's persistent kernel, split TF32 for layers 1-6 with
# its weight split), for the profiler's device times and (the first three)
# the build phase's spill check
CONV_KERNELS = ("conv_wg_kernel", "conv_audio_tc_kernel",
                "conv_audio_f32_kernel", "conv_tf32_kernel",
                "tf32_split_kernel")
# K5's kernels by name (bf16: wgmma + TMA; float32: split TF32 and its
# weights' split), for the profiler's device times
FFN_KERNELS = ("ffn_wg_kernel", "ffn_tf32_kernel", "tf32_split_kernel")
# the LayerNorm kernels by name (bf16: the vector kernel; float32: the
# simple oracle kernel) and F.layer_norm's, for the profiler's device times
# (the bf16 kernel also for the spill check)
LN_KERNELS = ("ln_vec_kernel", "ln_rows_kernel")
LIB_LN_KERNELS = ("layer_norm_kernel",)
# K9's kernels (bf16: the vector kernel, also for the spill check; float32:
# the simple oracle kernel; both: the cross-block pass), for the profiler's
# device times; the library call's device time sums every kernel it runs
LN_BWD_KERNELS = ("ln_bwd_vec_kernel", "ln_bwd_rows_kernel",
                  "ln_bwd_reduce_kernel")
# K10's three kernels by dtype (the rows pre-pass, dq, dk/dv), for the
# profiler's device times
ATTN_BWD_KERNELS = {
    torch.bfloat16: ("attn_bwd_rows_kernel", "attn_bwd_dq_tc_kernel",
                     "attn_bwd_dkdv_tc_kernel"),
    torch.float32: ("attn_bwd_rows_f32_kernel", "attn_bwd_dq_f32_kernel",
                    "attn_bwd_dkdv_f32_kernel")}
# the float32 attention kernels (split TF32), whose registers and spills
# the build phase reports apart
F32_ATTN_KERNELS = ("attn_fwd_f32_kernel", "attn_bwd_rows_f32_kernel",
                    "attn_bwd_dq_f32_kernel", "attn_bwd_dkdv_f32_kernel")
# the float32 GEMM kernels of K5 and K6 (split TF32, gemm.cuh's Tf32Gemm)
# and the weights' split, reported the same way, with the instances the
# report must hold: K5's two tile shapes by its two epilogues, one conv
# kernel, the split kernel (one name: ffn.cu's and convfuse.cu's copies
# share it)
F32_GEMM_KERNELS = {"ffn_tf32_kernel": 4, "conv_tf32_kernel": 1,
                    "tf32_split_kernel": 1}
# a K1 row width with a masked tail: not a multiple of 8, a partial pass
LN_TAIL_H = 1020
# LayerNorm launches a batch: the feature projection, two in each of the 15
# encoder layers and three in the SFC head; the unfused arm's conv epilogue
# runs once a conv layer.  The slice segments its two talks in two batches.
LN_PER_BATCH, CONV_LAYERS, SLICE_BATCHES = 34, 7, 2
# the base models' preset (facebook/wav2vec2-base: 12 post-LN layers of
# 768, 12 heads of 64, the group-norm conv stack without conv bias) under
# conf/task/shas.yaml's head (1 layer, 8 heads: D = 96)
BASE_MODEL, BASE_HEAD_DIM = "facebook/wav2vec2-base", 96


def phase(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


@contextlib.contextmanager
def env(values: dict):
    """Set environment variables for the block (the port reads its
    configuration flags at call time)."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ragged_mask(t: int, g: torch.Generator, dev, b: int = B) -> torch.Tensor:
    """[b, t] key mask: one row at t, one at about t/2, one at 1 frame, the
    rest random."""
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    fixed = torch.tensor([t, t // 2, 1])[:b]
    lengths[:len(fixed)] = fixed
    return (torch.arange(t)[None, :] < lengths[:, None]).to(dev)


def window_mask(b: int, t: int, valid: int | None, g, dev) -> torch.Tensor:
    """The key mask of a case: ragged rows, or every row ``valid`` frames
    long."""
    if valid is None:
        return ragged_mask(t, g, dev, b)
    return (torch.arange(t) < valid).expand(b, t).contiguous().to(dev)


def bound(nbytes: float, *ops: tuple[str, float]) -> tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the larger of the bytes over the memory rate and the operations, given
    as (rate, count) pairs, over the peak rate of their type (summed)."""
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = sum(n / PEAK_OPS[kind] for kind, n in ops) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def _kernel_name(mangled: str) -> str:
    """A kernel's name and the start of its template arguments from its
    mangled name in an anonymous namespace (_ZN<n><namespace><n><name>...),
    e.g. "attn_bwd_dq_tc_kernel ILi64EE"."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)
    if m is None:
        return mangled[:48]
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if m is None:
        return mangled[:48]
    n = int(m.group(1))
    name = rest[m.end():m.end() + n]
    return f"{name} {rest[m.end() + n:][:64]}"


def ptxas_report(log: str) -> dict:
    """nvcc's -Xptxas=-v log -> {kernel: "N registers, spills S/L bytes"}
    (ptxas prints a kernel's spills before its registers)."""
    import re

    report, name, spills = {}, None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = _kernel_name(m.group(1)), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            report[name] = f"{m.group(1)} registers, spills {spills} bytes"
            name = None
    return report


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def as_tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def attn_bwd_f64(q, k, v, mask, do, scale):
    """The attention backward in float64 from the same (bf16) inputs: the
    truth both bf16 routes approximate."""
    q, k, v, do = (a.double() for a in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s + torch.where(mask[:, None, None, :], 0.0,
                                      attn.NEG_INF).double(), -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, do))


def attn_bwd_slack(q, k, v, mask, do, scale) -> tuple:
    """Per-element room, beyond the bf16 output's atol and rtol, between
    two bf16 backwards that each round P and dS to bf16 before their
    products (K10 and attention_bwd_plain): a rounding that lands one bf16
    step (2^-7 of the value) apart, and dS's own difference, P times the
    change of delta from the forward output's bf16 rounding (2^-8 of
    |dO| . |O|, K10 takes delta from the bf16 O), carried through the
    float32 products: dq = scale |dS'| |K|, dk = scale |dS'|^T |Q|,
    dv = 2^-7 |P|^T |dO|.  Where a query row has few valid keys, dS is
    large and dk sums ~1000 such terms, so the room is many bf16 steps of
    dk; where its keys are many it is a fraction of atol."""
    qf, kf, vf, dof = (a.float() for a in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.softmax(s + torch.where(mask[:, None, None, :], 0.0,
                                      attn.NEG_INF), -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    d_delta = 2 ** -8 * (dof.abs() * o.abs()).sum(-1).transpose(1, 2)
    ds = (2 ** -7 * (p * (dp - (dp * p).sum(-1, keepdim=True))).abs()
          + p * d_delta[..., None])
    del s, dp
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf.abs()),
            scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf.abs()),
            2 ** -7 * torch.einsum("bhqk,bqhd->bkhd", p, dof.abs()))


def check_kernels(dev) -> dict:
    g = torch.Generator(device="cpu").manual_seed(0)
    gd = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gd, device=dev) * std
                + mean).to(dtype)

    def tc(dtype):  # the product's rate: tensor cores in bf16
        return "bf16_tc" if dtype == torch.bfloat16 else "f32"

    def tc_ops(dtype, flops):
        # the attention, FFN and conv (layers 1-6) kernels' products: bf16
        # tensor cores, or split TF32 (three TF32 products each) in float32
        if dtype == torch.bfloat16:
            return ("bf16_tc", flops)
        return ("tf32_tc", SPLIT_TF32 * flops)

    def ln_case(h, rows, gelu, dtype, valid=None):
        x = randn(rows, h, std=2.0, mean=0.5, dtype=dtype)
        if valid is not None:  # zero rows past a short window's audio
            x[valid:] = 0
        scale, bias = randn(h, std=0.1, mean=1.0), randn(h, std=0.1)
        moved = nbytes(x, x, scale, bias)
        # every LayerNorm row twice (bitwise), three timings (the median on
        # record), and the profiler's device time of the kernel; for K1
        # also F.layer_norm's, and both calls' host time a call (a short
        # kernel's events time is its host path's where that is longer)
        iters = 3 if rows > B * 32000 else 50
        if gelu:
            cb = randn(h, std=0.3)
            args = (x, cb, scale, bias)
            fn = lambda: ln.bias_layer_norm_gelu(*args)  # noqa: E731
            return dict(fn=fn,
                        plain=lambda: ln.bias_layer_norm_gelu_plain(*args),
                        bound=bound(moved + nbytes(cb), (
                            "f32", rows * h * (1 + LN_OPS + GELU_OPS))),
                        library=None, twice=True, repeats=3, iters=iters,
                        extra=lambda: {"device_ms": device_ms(fn, iters,
                                                              LN_KERNELS)})
        lib_scale, lib_bias = scale.to(dtype), bias.to(dtype)
        fn = lambda: ln.layer_norm(x, scale, bias)  # noqa: E731

        def library():
            return F.layer_norm(x, (h,), lib_scale, lib_bias, ln.EPS)

        return dict(fn=fn,
                    plain=lambda: ln.layer_norm_plain(x, scale, bias),
                    bound=bound(moved, ("f32", rows * h * LN_OPS)),
                    library=library, twice=True, repeats=3, iters=iters,
                    extra=lambda: {
                        "device_ms": device_ms(fn, iters, LN_KERNELS),
                        "library_device_ms": device_ms(library, iters,
                                                       LIB_LN_KERNELS),
                        "host_us": host_us(fn, iters),
                        "library_host_us": host_us(library, iters)})

    def pairs(mask, tq=None):
        # (query, key) pairs per head that need the products: the valid
        # keys of every query row, and a batch-padding row's in-range keys
        # (its output averages them: PV, and no QK, is needed there); tq
        # query rows (the keys' count where not given)
        tk = mask.shape[1]
        tq = tk if tq is None else tq
        valid = float(tq * mask.sum().double())
        return valid, float(tq * tk * int((~mask.any(1)).sum()))

    def attn_bound(q, mask, heads, d, dtype):
        # QK and PV (2 * D FLOP a pair each) over the pairs that need them
        valid, empty = pairs(mask)
        flops = heads * d * (4 * valid + 2 * empty)
        return bound(4 * nbytes(q), tc_ops(dtype, flops))

    def sdpa(q, k, v, mask):  # [B, T, H, D] views -> the library call
        m = mask[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m)

    def uniform_row(v, heads, d):
        # the batch-padding row 3 (every key masked) must average its
        # in-range values with equal weights: its error against that mean
        want = v[3].float().mean(0)
        return lambda out: float((out.view(v.shape[0], -1, heads, d)[3]
                                  .float() - want).abs().max())

    def packed_case(t, dtype, b=B, valid=None):
        proj = randn(b, t, 3 * 1024, dtype=dtype)
        mask = window_mask(b, t, valid, g, dev)
        if b > 3:
            mask[3] = False  # a batch-padding row: every key masked
        q, k, v = attn._unpack_qkv(proj, 16)
        return dict(fn=lambda: attn.attention_packed(proj, mask, 16),
                    plain=lambda: attn.attention_packed_plain(
                        proj, mask, 16, 64 ** -0.5),
                    uniform=uniform_row(v, 16, 64) if b > 3 else None,
                    bound=attn_bound(q, mask, 16, 64, dtype),
                    library=sdpa(q, k, v, mask), twice=True, repeats=3)

    def bthd_case(t, dtype, b=B, valid=None, d=128):
        # the SFC's view layout; d = 96 at a base model's width (768 / 8)
        qkv = randn(b, t, 3, 8, d, dtype=dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        mask = window_mask(b, t, valid, g, dev)
        if b > 3:
            mask[3] = False
        return dict(fn=lambda: attn.attention_bthd(q, k, v, mask),
                    plain=lambda: attn.attention_bthd_plain(
                        q, k, v, mask, d ** -0.5),
                    uniform=uniform_row(v, 8, d) if b > 3 else None,
                    bound=attn_bound(q, mask, 8, d, dtype),
                    library=sdpa(q, k, v, mask), twice=True, repeats=3)

    def cross_case(tq, tk, dtype):
        # the arseg decoder's cross-attention: queries of the decoder's
        # T_tgt (or fewer) rows over the packed K/V of the encoder memory
        q = randn(B, tq, 8, 128, dtype=dtype)
        kv = randn(B, tk, 2, 8, 128, dtype=dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
        mask = ragged_mask(tk, g, dev)
        mask[3] = False
        valid, empty = pairs(mask, tq)
        return dict(fn=lambda: attn.attention_cross(q, kv, mask),
                    plain=lambda: attn.attention_bthd_plain(
                        q, k, v, mask, 128 ** -0.5),
                    uniform=uniform_row(v, 8, 128),
                    bound=bound(2 * nbytes(q) + nbytes(kv), tc_ops(
                        dtype, 8 * 128 * (4 * valid + 2 * empty))),
                    library=sdpa(q, k, v, mask), twice=True, repeats=3)

    def row_dot_case(rows, dtype):
        # the bce head's output layer: the final LayerNorm's output (about
        # unit variance) against the output column of 1024
        x = randn(rows, 1024, dtype=dtype)
        w = randn(1024, std=1024 ** -0.5, dtype=dtype)
        b = randn(1, std=0.1, dtype=dtype)
        lib_w = w[None, :]

        def inspect(got, ref):
            # C18: the kernel's order bitwise in bf16 (a bf16 product is
            # exact in float32), and a window's rows alone as in the batch
            out = got[0]
            if dtype == torch.bfloat16:
                check(torch.equal(out, rowdot.row_dot_ordered(x, w, b)),
                      "row_dot: not the kernel order's result")
            for k in (0, rows // T - 1):
                alone = rowdot.row_dot(x[k * T:(k + 1) * T].clone(), w, b)
                check(torch.equal(alone, out[k * T:(k + 1) * T]),
                      f"row_dot: window {k} alone differs from the batch")

        return dict(fn=lambda: rowdot.row_dot(x, w, b),
                    plain=lambda: rowdot.row_dot_plain(x, w, b),
                    inspect=inspect, twice=True,
                    bound=bound(nbytes(x, w, b) + rows * x.element_size(),
                                ("f32", 2 * rows * 1024)),
                    library=lambda: F.linear(x, lib_w, b))

    def ln_bwd_case(h, rows, dtype, need_dx=True):
        x = randn(rows, h, std=2.0, mean=0.5, dtype=dtype)
        gr = randn(rows, h, dtype=dtype)
        scale = randn(h, std=0.1, mean=1.0)
        lib_w = scale.to(dtype)
        lib_b = torch.zeros(h, device=dev, dtype=dtype)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [h], lib_w, lib_b,
                                                         ln.EPS)
        # x and g read, dx written (where asked), scale read, dscale and
        # dbias written
        moved = nbytes(x, gr, scale) + 2 * h * 4 + (nbytes(x) if need_dx
                                                    else 0)
        # without dx the wrapper returns None in its place: held here, the
        # rows compare dscale and dbias
        # (the rows with dx pass no flag, so that this script also times
        # an earlier checkout's kernel on the same inputs)
        kw = {} if need_dx else {"need_dx": False}
        check(need_dx or ln.layer_norm_bwd(x, scale, gr, **kw)[0] is None,
              "layer_norm_bwd wrote a dx it was not asked for")
        keep = slice(0 if need_dx else 1, None)
        fn = lambda: ln.layer_norm_bwd(x, scale, gr, **kw)[keep]  # noqa: E731

        def library():
            return torch.ops.aten.native_layer_norm_backward(
                gr, x, [h], mean, rstd, lib_w, lib_b, [need_dx, True, True])

        # K9 sits within a few percent of its library call: 50 launches a
        # timing, three timings of each in turns, the spread reported
        return dict(fn=fn,
                    plain=lambda: ln.layer_norm_bwd_plain(x, scale, gr,
                                                          **kw)[keep],
                    bound=bound(moved, ("f32", rows * h * LN_BWD_OPS)),
                    library=library, rtol=BWD_RTOL, twice=True, iters=50,
                    repeats=3,
                    extra=lambda: {
                        "device_ms": device_ms(fn, 50, LN_BWD_KERNELS),
                        "device_ms_total": device_ms(fn, 50, ("",))[""],
                        # the second kernel's launch overlaps the first's
                        # tail: the call's time on the device, overlap once
                        "device_busy_ms": device_busy_ms(fn, 50),
                        "library_device_ms": device_ms(library, 50,
                                                       ("",))[""],
                        "host_us": host_us(fn, 50),
                        "library_host_us": host_us(library, 50)})

    def attn_bwd_case(t, heads, d, dtype, tq=None):
        if tq is None:
            qkv = randn(B, t, 3, heads, d, dtype=dtype)  # the head's gradient
            q, k, v = qkv.unbind(2)
            do = randn(B, t, heads, d, dtype=dtype)
        else:  # the arseg cross-attention: tq queries, t keys
            q = randn(B, tq, heads, d, dtype=dtype)
            k, v = randn(B, t, 2, heads, d, dtype=dtype).unbind(2)
            do = randn(B, tq, heads, d, dtype=dtype)
        mask = ragged_mask(t, g, dev)
        mask[3] = False  # a batch-padding row: every key masked
        scale = d ** -0.5
        # S = QK^T, dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q over
        # the valid keys of every query row; all but S over the padding
        # row's keys (its P is uniform)
        valid, empty = pairs(mask, tq)
        flops = heads * d * (10 * valid + 8 * empty)
        # the SDPA call's backward: forward + backward less the forward
        leaves = [a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v)]
        do_t = do.transpose(1, 2)

        def lib_fwd():
            return F.scaled_dot_product_attention(
                *leaves, attn_mask=mask[:, None, None, :])

        case = dict(plain=lambda: attn.attention_bwd_plain(q, k, v, mask,
                                                           do, scale),
                    # the TPU kernel's function: q, k, v and do in, dq, dk
                    # and dv out (the bf16 kernels' extra reads of the
                    # forward's output and statistics are not counted)
                    bound=bound(3 * nbytes(q) + 4 * nbytes(k),
                                tc_ops(dtype, flops)),
                    library=lambda: torch.autograd.grad(lib_fwd(), leaves,
                                                        do_t),
                    library_less=lib_fwd, rtol=BWD_RTOL, twice=True,
                    repeats=3)
        # the forward under grad writes the statistics the backward reads,
        # once, outside the timed region; they are held against their
        # plain version, and the forward with them is timed against the
        # inference forward
        o, stats = attn._attention_bthd(q, k, v, mask, scale,
                                        with_stats=True)
        want = attn.attention_stats_plain(q, k, mask, scale)
        stats_err = (stats - want).abs()
        check(bool((stats_err <= STATS_ATOL + STATS_RTOL * want.abs()).all()),
              f"attention statistics [{B},{tq or t}x{t},{heads},{d}]: max "
              f"abs err {stats_err.max().item()}")

        cross = {}
        if tq is not None and dtype == torch.bfloat16:
            # the cross rows: the outputs' room of attn_bwd_slack on top of
            # the self rows' limits (a random key count of a few keys,
            # which the self rows' draws happened not to give, puts two
            # bf16 steps of a dk of ~30 between the two routes at either
            # geometry); reported: the elements beyond the self rows'
            # limits and each route's distance from the float64 backward
            case["slack"] = attn_bwd_slack(q, k, v, mask, do, scale)

            def cross_extra(got, ref):
                cross["slack_max"] = [float(r.max()) for r in case["slack"]]
                truth = attn_bwd_f64(q, k, v, mask, do, scale)
                cross["beyond_self_limits"] = [
                    int(((a.float() - b.float()).abs() > BF16_ATOL
                         + BWD_RTOL[dtype] * b.float().abs()).sum())
                    for a, b in zip(got, ref)]
                for name, out in (("kernel", got), ("plain", ref)):
                    cross[f"f64_max_err_{name}"] = [
                        float((a.double() - w).abs().max())
                        for a, w in zip(out, truth)]
                    cross[f"f64_mean_err_{name}"] = [
                        float((a.double() - w).abs().mean())
                        for a, w in zip(out, truth)]

            case["inspect"] = cross_extra
        elif dtype == torch.float32:
            # each route's distance from the float64 backward: where a
            # one-key row sums ~1000 terms into a dv of ~100, the plain
            # version's own float32 rounding is most of the distance
            def f64_extra(got, ref):
                truth = attn_bwd_f64(q, k, v, mask, do, scale)
                for name, out in (("kernel", got), ("plain", ref)):
                    cross[f"f64_max_err_{name}"] = [
                        float((a.double() - w).abs().max())
                        for a, w in zip(out, truth)]

            case["inspect"] = f64_extra
        case.update(
            fn=lambda: attn.attention_bwd(q, k, v, mask, do, scale, o, stats),
            extra=lambda: {
                **cross,
                "stats_max_abs_err": stats_err.max().item(),
                "fwd_ms": cuda_ms(lambda: attn.attention_bthd(q, k, v, mask,
                                                              scale), 10),
                "fwd_stats_ms": cuda_ms(lambda: attn._attention_bthd(
                    q, k, v, mask, scale, with_stats=True), 10),
                "device_ms": device_ms(
                    lambda: attn.attention_bwd(q, k, v, mask, do, scale, o,
                                               stats), 10,
                    ATTN_BWD_KERNELS[dtype])})
        return case

    def ffn_case(t, dtype, windows=B, valid=None):
        x = randn(windows, t, 1024, dtype=dtype)
        if valid is not None:
            x[:, valid:] = 0
        w1, b1 = randn(4096, 1024, std=0.03), randn(4096, std=0.1)
        w2, b2 = randn(1024, 4096, std=0.015), randn(1024, std=0.1)
        rows = windows * t
        moved = 2 * nbytes(x) + (w1.numel() + w2.numel()) * x.element_size() \
            + nbytes(b1, b2)
        args = (x, w1, b1, w2, b2)
        # a reference point, not the library column: the cuBLAS chain of
        # three calls in x's type
        lw1, lb1, lw2, lb2 = (a.to(dtype) for a in (w1, b1, w2, b2))

        def chain():
            return F.linear(F.gelu(F.linear(x, lw1, lb1)), lw2, lb2)

        # every FFN row twice (bitwise), three timings (the median on
        # record), and the profiler's device time of the FFN kernels
        return dict(fn=lambda: tffn.ffn(*args),
                    plain=lambda: tffn.ffn_plain(*args),
                    bound=bound(moved, tc_ops(dtype, 4 * rows * 1024 * 4096),
                                ("f32", rows * 4096 * (1 + GELU_OPS))),
                    library=None, twice=True, repeats=3,
                    extra=lambda: {"cublas_chain_ms": cuda_ms(chain, 10),
                                   "device_ms": device_ms(
                                       lambda: tffn.ffn(*args), 10,
                                       FFN_KERNELS)})

    def conv_case(t, c, k, s, dtype, b=B, valid=None):
        x = randn(b, t, c, dtype=dtype)
        if valid is not None:
            x[:, valid:] = 0
        w = randn(512, c, k, std=(c * k) ** -0.5)
        cb, scale, bias = (randn(512, std=0.3), randn(512, std=0.1, mean=1.0),
                           randn(512, std=0.1))
        args = (x, w, cb, scale, bias, s)
        rows = b * ((t - k) // s + 1)
        moved = nbytes(x) + rows * 512 * x.element_size() \
            + w.numel() * x.element_size() + nbytes(cb, scale, bias)
        product = 2 * rows * k * c * 512
        # layers 1-6 on the tensor cores (split TF32 in float32); the
        # raw-audio layer 0 (k*C <= 16) in bf16 on them, in float32 on the
        # scalar pipes
        ops = (tc_ops(dtype, product) if k * c > conv.AUDIO_MAX_K
               else (tc(dtype), product))
        epilogue = rows * 512 * (1 + LN_OPS + GELU_OPS)
        # a reference point, not the library column: the cuDNN chain of
        # three calls in x's type, conv1d on the channels-first view ->
        # layer_norm -> gelu
        lw, lcb, lsc, lbi = (a.to(dtype) for a in (w, cb, scale, bias))

        def chain():
            y = F.conv1d(x.transpose(1, 2), lw, lcb, stride=s)
            return F.gelu(F.layer_norm(y.transpose(1, 2), (512,), lsc, lbi,
                                       ln.EPS))

        # every conv row twice (bitwise), three timings (the median on
        # record), and the profiler's device time of the conv kernels
        return dict(fn=lambda: conv.conv_bias_ln_gelu(*args),
                    plain=lambda: conv.conv_bias_ln_gelu_plain(*args),
                    bound=bound(moved, ops, ("f32", epilogue)),
                    library=None, twice=True, repeats=3,
                    extra=lambda: {"cudnn_chain_ms": cuda_ms(chain, 3),
                                   "device_ms": device_ms(
                                       lambda: conv.conv_bias_ln_gelu(*args),
                                       3, CONV_KERNELS)})

    cases = []  # (kernel, label, dtype, case)
    for dtype in (torch.float32, torch.bfloat16):
        for h in (1024, 512):
            cases.append(("layer_norm", f"[{B}*{T},{h}]", dtype,
                          lambda h=h, d=dtype: ln_case(h, B * T, False, d)))
        for t in (63999, T):
            cases.append(("bias_layer_norm_gelu", f"[{B},{t},512]", dtype,
                          lambda t=t, d=dtype: ln_case(512, B * t, True, d)))
        for t in (T, T_TAIL):
            cases.append(("attention_packed", f"[{B},{t},3072]x16", dtype,
                          lambda t=t, d=dtype: packed_case(t, d)))
        for t in (T, T_TAIL):
            cases.append(("attention_bthd", f"[{B},{t},8,128]", dtype,
                          lambda t=t, d=dtype: bthd_case(t, d)))
        for t in (T, T_TAIL):
            cases.append(("ffn", f"[{B},{t},1024]x4096", dtype,
                          lambda t=t, d=dtype: ffn_case(t, d)))
        # conv layer 1 (k=3, s=2) and layer 6 (k=2, s=2); layer 0's raw audio
        for t, k, s in ((63999, 3, 2), (1999, 2, 2)):
            cases.append(("conv_bias_ln_gelu", f"[{B},{t},512] k={k} s={s}",
                          dtype,
                          lambda t=t, k=k, s=s, d=dtype: conv_case(
                              t, 512, k, s, d)))
        cases.append(("conv_audio_ln_gelu", f"[{B},{L_AUDIO}] k=10 s=5", dtype,
                      lambda d=dtype: conv_case(L_AUDIO, 1, 10, 5, d)))
        cases.append(("layer_norm_bwd", f"[{B}*{T},1024]", dtype,
                      lambda d=dtype: ln_bwd_case(1024, B * T, d)))
        for heads, d in ((8, 128), (16, 64)):
            cases.append(("attention_bwd", f"[{B},{T},{heads},{d}]", dtype,
                          lambda h=heads, dd=d, dt=dtype: attn_bwd_case(
                              T, h, dd, dt)))
    # the remainder ladder's 1, 2 and 4 windows, last, so that the rows
    # above draw the same inputs from the shared stream as in earlier runs
    for dtype in (torch.float32, torch.bfloat16):
        for w in (1, 2, 4):
            cases.append(("ffn", f"[{w},{T},1024]x4096", dtype,
                          lambda d=dtype, w=w: ffn_case(T, d, w)))
    # conv layers 2-5, after every earlier row for the same reason
    for dtype in (torch.float32, torch.bfloat16):
        for t, k, s in CONV_MIDDLE:
            cases.append(("conv_bias_ln_gelu", f"[{B},{t},512] k={k} s={s}",
                          dtype,
                          lambda t=t, k=k, s=s, d=dtype: conv_case(
                              t, 512, k, s, d)))
    # K1 at the tail bucket's ragged row count and at a width with a
    # masked tail (not a multiple of 8: element-wise loads and stores), K2
    # at conv layer 1's output (the unfused arm), after every earlier row
    # for the same reason
    for dtype in (torch.float32, torch.bfloat16):
        for rows, h in ((B * T_TAIL, 1024), (B * T, LN_TAIL_H)):
            cases.append(("layer_norm", f"[{B}*{rows // B},{h}]", dtype,
                          lambda h=h, r=rows, d=dtype: ln_case(h, r, False,
                                                               d)))
        cases.append(("bias_layer_norm_gelu", f"[{B},31999,512]", dtype,
                      lambda d=dtype: ln_case(512, B * 31999, True, d)))
    # K9 at A4's feature-projection width and at a width with a masked
    # tail, then without dx (the head's first LayerNorm in training), after
    # every earlier row for the same reason
    for h, need_dx in ((512, True), (LN_TAIL_H, True), (1024, False)):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(("layer_norm_bwd",
                          f"[{B}*{T},{h}]" + ("" if need_dx else " no dx"),
                          dtype, lambda h=h, d=dtype, n=need_dx: ln_bwd_case(
                              h, B * T, d, n)))

    # the online path's shapes (MultiStreamSegmenter's slots of 1 and 8
    # windows, and one window holding 0.5 s of audio, a stream's final
    # flush, its padding zero): K1, K3-K7 in bf16, after every earlier row
    # for the same reason
    bf16 = torch.bfloat16
    for b, secs in ((1, None), (8, None), (1, 0.5)):
        tag = f" B={b}" + ("" if secs is None else f" {secs}s valid")
        frames = None if secs is None else int(secs * 49.95)
        samples = None if secs is None else int(secs * 16000)
        conv0 = None if secs is None else (samples - 10) // 5 + 1
        cases += [
            ("layer_norm", f"[{b}*{T},1024]{tag}", bf16,
             lambda b=b, v=frames: ln_case(1024, b * T, False, bf16, v)),
            ("attention_packed", f"[{b},{T},3072]x16{tag}", bf16,
             lambda b=b, v=frames: packed_case(T, bf16, b, v)),
            ("attention_bthd", f"[{b},{T},8,128]{tag}", bf16,
             lambda b=b, v=frames: bthd_case(T, bf16, b, v)),
            ("ffn", f"[{b},{T},1024]x4096{tag}", bf16,
             lambda b=b, v=frames: ffn_case(T, bf16, b, v)),
            ("conv_bias_ln_gelu", f"[{b},63999,512] k=3 s=2{tag}", bf16,
             lambda b=b, v=conv0: conv_case(63999, 512, 3, 2, bf16, b, v)),
            ("conv_audio_ln_gelu", f"[{b},{L_AUDIO}] k=10 s=5{tag}", bf16,
             lambda b=b, v=samples: conv_case(L_AUDIO, 1, 10, 5, bf16, b,
                                              v)),
        ]

    # the arseg decoder's cross-attention (tq queries over tk = 999 memory
    # frames: the decoder's 1000 SEP-led rows, and a short 64-row query
    # block), K4 and K10 in both dtypes, after every earlier row for the
    # same reason
    for dtype in (torch.float32, torch.bfloat16):
        for tq in (T + 1, 64):
            cases.append(("attention_bthd", f"[{B},{tq}x{T},8,128] cross",
                          dtype, lambda tq=tq, d=dtype: cross_case(tq, T, d)))
            cases.append(("attention_bwd", f"[{B},{tq}x{T},8,128] cross",
                          dtype, lambda tq=tq, d=dtype: attn_bwd_case(
                              T, 8, 128, d, tq)))

    # the bce head's output layer (C18) at the main path's rows, last, for
    # the same reason
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(("row_dot", f"[{B}*{T},1024]x1", dtype,
                      lambda d=dtype: row_dot_case(B * T, d)))

    # K4 at the base models' SFC head (768 channels, 8 heads of 96; the
    # D = 128 schedule over a zero-filled half box), last, for the same
    # reason
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(("attention_bthd", f"[{B},{T},8,{BASE_HEAD_DIM}]", dtype,
                      lambda d=dtype: bthd_case(T, d, d=BASE_HEAD_DIM)))

    # K10 at the base models' head dim: the SFC head's [14, 999, 8, 96]
    # and arseg's cross-attention on a base backbone (1000 queries over
    # 999 keys), both with ragged keys and an all-masked row, last, for
    # the same reason
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(("attention_bwd", f"[{B},{T},8,{BASE_HEAD_DIM}]", dtype,
                      lambda d=dtype: attn_bwd_case(T, 8, BASE_HEAD_DIM, d)))
        cases.append(("attention_bwd",
                      f"[{B},{T + 1}x{T},8,{BASE_HEAD_DIM}] cross", dtype,
                      lambda d=dtype: attn_bwd_case(T, 8, BASE_HEAD_DIM, d,
                                                    T + 1)))

    results: dict = {}
    results_f32: dict = {}
    for name, label, dtype, make in cases:
        case = make()
        got, ref = as_tuple(case["fn"]()), as_tuple(case["plain"]())
        again = as_tuple(case["fn"]()) if case.get("twice") else None
        torch.cuda.synchronize()
        # each output is held to the limits of its own dtype: K9's dscale
        # and dbias are float32 column sums whatever x's dtype
        tols = {torch.float32: F32_ATOL, torch.bfloat16: BF16_ATOL}
        rtols = case.get("rtol", {})
        slack = case.get("slack") or (0.0,) * len(got)
        err, ok, limits = 0.0, True, []
        for a, b, room in zip(got, ref, slack):
            check(torch.isfinite(a).all().item(), f"{name} {label}: non-finite")
            tol, rtol = tols[a.dtype], rtols.get(a.dtype, 0.0)
            limits.append((tol, rtol))
            diff = (a.float() - b.float()).abs()
            lim = tol + rtol * b.float().abs() + room
            err = max(err, diff.max().item())
            ok = ok and bool((diff <= lim).all())
        if case.get("inspect") is not None:
            case["inspect"](got, ref)
        if case.get("uniform") is not None:
            uniform_err = case["uniform"](got[0])
            err = max(err, uniform_err)
            ok = ok and uniform_err <= tols[got[0].dtype]
        deterministic = (None if again is None else
                         all(torch.equal(a, b) for a, b in zip(got, again)))
        del got, ref, again
        big = "63999" in label or str(L_AUDIO) in label
        iters = case.get("iters", 3 if big else 10)

        def library():
            if case["library"] is None:
                return None
            ms_ = cuda_ms(case["library"], iters)
            if case.get("library_less") is not None:
                ms_ -= cuda_ms(case["library_less"], iters)
            return ms_

        # with repeats, the kernel and its library call in turns; the
        # median of each goes on record, every timing into the phase line
        runs = {"ms": [], "library_ms": []}
        for r in range(case.get("repeats", 1)):
            for key in (("ms", "library_ms") if r % 2 == 0
                        else ("library_ms", "ms")):
                runs[key].append(cuda_ms(case["fn"], iters) if key == "ms"
                                 else library())
        ms = float(np.median(runs["ms"]))
        library_ms = (None if runs["library_ms"][0] is None
                      else float(np.median(runs["library_ms"])))
        plain_ms = cuda_ms(case["plain"], iters)
        extra = case["extra"]() if case.get("extra") is not None else {}
        if case.get("repeats", 1) > 1:
            extra.update(ms_repeats=runs["ms"],
                         library_ms_repeats=runs["library_ms"])
        bound_ms, bound_by = case["bound"]
        dname = str(dtype).replace("torch.", "")
        phase("kernel", name=name, shape=label, dtype=dname, max_abs_err=err,
              limits=limits, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=library_ms,
              deterministic=deterministic, iters=iters, **extra)
        check(ok, f"{name} {label} {dname}: max abs err {err} beyond "
                  f"the (atol, rtol) limits {limits}")
        check(deterministic is not False,
              f"{name} {label} {dname}: two runs differ")
        del case
        torch.cuda.empty_cache()
        # the record keeps the main path's dtype (bf16) at its first shape,
        # and the float32 route's row at that shape (the precision ladder's
        # f32 arms)
        # (and K4's and K10's rows at the base models' head dim under
        # "d96", K10's cross row under "d96_cross")
        record = results if dtype == torch.bfloat16 else results_f32
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        if name not in record:
            record[name] = row
        elif label == f"[{B},{T},8,{BASE_HEAD_DIM}]":
            record[name]["d96"] = row
        elif label == f"[{B},{T + 1}x{T},8,{BASE_HEAD_DIM}] cross":
            record[name]["d96_cross"] = row
    for name, row in results_f32.items():
        results[name]["f32"] = row
    return results


def talk_pcm(secs: float, seed: int) -> np.ndarray:
    """Speech-like audio: amplitude-modulated noise with a pause every 3.5 s
    and slowly varying loudness, 16 kHz 16-bit mono samples."""
    rng = np.random.RandomState(seed)
    n = int(secs * 16000)
    t = np.arange(n) / 16000
    x = rng.randn(n) * 0.1 * ((t % 3.5) < 3.0)
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * t / 7.3 + seed)
    return np.clip(x * 32768.0, -32768, 32767).astype("<i2")


def write_talk(path: Path, secs: float, seed: int) -> None:
    """``talk_pcm``'s audio as a wav file."""
    pcm = talk_pcm(secs, seed)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())


def run_slice(dev) -> tuple[dict, dict, SHAS]:
    model = SHAS(device=dev)  # conf/task/shas.yaml: xls-r-300m, 15 layers
    init_from_numpy(model, seed=0)
    with torch.no_grad():
        model.seg_model.output_layer.weight.mul_(40.0)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    cfg = model.w2v_cfg
    check(cfg.hidden_size == 1024 and cfg.num_layers == 15
          and cfg.num_heads == 16 and cfg.ffn_dim == 4096, "not full width")

    with tempfile.TemporaryDirectory() as tmp:
        secs = {"talk1.wav": 65.0, "talk2.wav": 41.0}
        wavs = [Path(tmp) / name for name in secs]
        for seed, w in enumerate(wavs):
            write_talk(w, secs[w.name], seed)
        audio_secs = sum(secs.values())

        reads: list = []  # read + collate ms a batch, in the reader

        def run(mode: str, dtype=torch.bfloat16, flags: dict | None = None):
            backend.set_kernels(mode)
            before = backend.launch_counts()
            probs: dict = {}
            with env(flags or {}):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = segment_wavs(model, wavs, PTHR, B, 20.0, 1, dev, dtype,
                                    talk_probs=probs, read_seconds=reads)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            backend.set_kernels("auto")
            if mode == "eager":
                check(backend.launch_counts() == before,
                      "the eager run launched kernels")
            return rows, probs, wall

        # warm-up: cuBLAS/cuDNN handles, pinned memory, kernels
        run("auto")
        run("auto", flags=UNFUSED)
        run("eager")
        backend.reset_launch_counts()
        reads.clear()
        rows_k, probs_k, wall = run("auto")
        counts = backend.launch_counts()
        read_ms = [t * 1e3 for t in reads]
        walls = {"auto": [wall], "eager": [], "unfused": []}
        rows_e, probs_e, wall = run("eager")
        walls["eager"].append(wall)
        backend.reset_launch_counts()
        rows_u, probs_u, wall = run("auto", flags=UNFUSED)
        counts_unfused = backend.launch_counts()
        walls["unfused"].append(wall)
        for mode in ("eager", "unfused", "auto", "auto", "unfused", "eager"):
            walls[mode].append(
                run("auto", flags=UNFUSED)[2] if mode == "unfused"
                else run(mode)[2])
        _, probs_f32, _ = run("auto", torch.float32)  # the float32 oracle

    for name in INFER_PATH:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the default path")
    # six conv layers on conv_bias_ln_gelu for each raw-audio layer 0
    check(counts["conv_bias_ln_gelu"] == 6 * counts["conv_audio_ln_gelu"],
          f"conv launches {counts['conv_bias_ln_gelu']} / "
          f"{counts['conv_audio_ln_gelu']}, not six layers to one")
    for name in UNFUSED_PATH:
        check(counts_unfused.get(name, 0) > 0,
              f"kernel {name} never launched on the unfused path")
    check(counts["row_dot"] == SLICE_BATCHES
          and counts_unfused["row_dot"] == SLICE_BATCHES,
          f"row_dot launches {counts['row_dot']} / "
          f"{counts_unfused['row_dot']}, not one a batch")
    check(counts["layer_norm"] == LN_PER_BATCH * SLICE_BATCHES
          and counts_unfused["layer_norm"] == LN_PER_BATCH * SLICE_BATCHES,
          f"layer_norm launches {counts['layer_norm']} / "
          f"{counts_unfused['layer_norm']}, not {LN_PER_BATCH} a batch")
    check(counts_unfused["bias_layer_norm_gelu"]
          == CONV_LAYERS * SLICE_BATCHES,
          f"bias_layer_norm_gelu launches "
          f"{counts_unfused['bias_layer_norm_gelu']}, not {CONV_LAYERS} a "
          f"batch")
    for rows in (rows_k, rows_e, rows_u):
        check({r["wav"] for r in rows} == {w.name for w in wavs},
              "a talk got no segments")
    names = list(secs)
    for probs in (probs_k, probs_e, probs_u, probs_f32):
        for name in names:
            p = probs[name]
            # one frame per 1/49.95 s, the output frame rate
            check(p.shape == (round(secs[name] * 49.95),), "probs shape")
            check(bool(np.isfinite(p).all()), "non-finite probs")

    def dprob(a, b):
        d = np.concatenate([np.abs(a[n] - b[n]) for n in names])
        return {"mean": float(d.mean()), "p99": float(np.percentile(d, 99)),
                "max": float(d.max()), "frames": int(d.size)}

    k_vs_e = dprob(probs_k, probs_e)
    k_vs_f = dprob(probs_k, probs_f32)
    e_vs_f = dprob(probs_e, probs_f32)
    u_vs_k = dprob(probs_u, probs_k)
    u_vs_f = dprob(probs_u, probs_f32)
    med = {m: float(np.median(w)) for m, w in walls.items()}
    phase("slice", reader_backend=native_reads(),
          params=n_params, segments_kernels=len(rows_k),
          segments_eager=len(rows_e), segments_unfused=len(rows_u),
          prob_range=[float(min(p.min() for p in probs_k.values())),
                      float(max(p.max() for p in probs_k.values()))],
          dprob_kernels_vs_eager=k_vs_e, dprob_kernels_vs_f32=k_vs_f,
          dprob_eager_vs_f32=e_vs_f, dprob_unfused_vs_kernels=u_vs_k,
          dprob_unfused_vs_f32=u_vs_f,
          jax_envelope_met=all(k_vs_e[q] <= JAX_ENVELOPE[q]
                               for q in JAX_ENVELOPE),
          audio_secs=audio_secs, wall_secs_kernels=walls["auto"],
          wall_secs_eager=walls["eager"], wall_secs_unfused=walls["unfused"],
          audio_per_wall_kernels=audio_secs / med["auto"],
          audio_per_wall_eager=audio_secs / med["eager"],
          audio_per_wall_unfused=audio_secs / med["unfused"],
          read_ms_per_batch=read_ms,
          launches=counts, launches_unfused=counts_unfused)
    for q in ("mean", "p99"):
        check(k_vs_f[q] <= KERNEL_SLACK * e_vs_f[q],
              f"kernels add error: {q} dprob to float32 {k_vs_f[q]} vs "
              f"{e_vs_f[q]} on the plain path")
        check(k_vs_e[q] <= e_vs_f[q],
              f"kernel vs eager {q} dprob {k_vs_e[q]} exceeds the bf16 "
              f"envelope {e_vs_f[q]}")
        pair = BF16_PAIR * max(k_vs_f[q], u_vs_f[q])
        check(u_vs_k[q] <= pair,
              f"unfused vs default {q} dprob {u_vs_k[q]} exceeds the bf16 "
              f"envelope of two bf16 paths {pair}")
    return counts, counts_unfused, model


def full_batch_examples() -> list:
    """The 14 windows of 20 s of the full batch, as (audio, target, start,
    end) examples."""
    rng = np.random.RandomState(2)
    env_ = (np.arange(L_AUDIO) / 16000 % 3.5) < 3.0
    return [((rng.randn(L_AUDIO) * 0.1 * env_).astype(np.float32), None,
             0, 999) for _ in range(B)]


def full_batch():
    """One full batch of 14 windows of 20 s, as the segment path reads it."""
    from wav2vecsegmenter_tpu_torch.data.windows import BatchIterator

    # a list serves as the dataset
    batch, = BatchIterator(full_batch_examples(), B, 20.0)
    return batch


def time_batch(dev, model, profile: bool) -> None:
    """One full batch (14 windows of 20 s) through the engine: the default
    configuration with the kernels, the unfused one with the kernels, and
    eager, in turns; with ``profile``, a torch.profiler table of one batch
    in each configuration goes to standard error."""
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference

    batch = full_batch()
    engine = WindowInference(model, dev, torch.bfloat16)

    def once(arm):
        backend.set_kernels("eager" if arm == "eager" else "auto")
        with env(UNFUSED if arm == "unfused" else {}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run_batch(batch).numpy()
            ms = (time.perf_counter() - t0) * 1e3
        backend.set_kernels("auto")
        return ms

    ms = {"auto": [], "unfused": [], "eager": []}
    for arm in ms:
        once(arm)
    torch.cuda.reset_peak_memory_stats()
    for arm in ("auto", "unfused", "eager", "eager", "unfused", "auto",
                "auto", "unfused", "eager"):
        ms[arm].append(once(arm))
    med = {arm: float(np.median(v)) for arm, v in ms.items()}
    phase("batch", windows=B, audio_secs=B * 20.0, ms_kernels=ms["auto"],
          ms_unfused_kernels=ms["unfused"], ms_eager=ms["eager"],
          audio_per_wall_kernels=B * 20.0 / (med["auto"] / 1e3),
          audio_per_wall_unfused=B * 20.0 / (med["unfused"] / 1e3),
          audio_per_wall_eager=B * 20.0 / (med["eager"] / 1e3),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        for arm in ("auto", "unfused"):
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                once(arm)
            print(f"batch profile, {arm} arm", file=sys.stderr)
            print(p.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=40),
                  file=sys.stderr, flush=True)


def batch_launches(model) -> dict:
    """The kernel launches of one batch in the default configuration: a
    LayerNorm for the feature projection, two a layer of the encoder and
    of the head and the head's last; attention and the FFN once an encoder
    layer; the head's attention once a head layer; conv layers 1-6 and
    layer 0 (none in a base model's group-norm stack, which no conv kernel
    takes); the bce head's output layer (the row-local kernel; a head of
    V > 1 stays a matmul)."""
    cfg = model.w2v_cfg
    layers = cfg.num_layers
    head = len(model.seg_model.transformer.layers)
    conv_kernels = cfg.feat_extract_norm == "layer" and cfg.conv_bias
    return {"layer_norm": 1 + 2 * layers + 2 * head + 1,
            "attention_packed": layers, "attention_bthd": head,
            "ffn": layers, "conv_bias_ln_gelu": 6 * conv_kernels,
            "conv_audio_ln_gelu": int(conv_kernels),
            "row_dot": int(model.seg_model.vocab_size == 1)}


def dprob_stats(d: np.ndarray) -> dict:
    return {"mean": float(d.mean()), "p99": float(np.percentile(d, 99)),
            "max": float(d.max()), "frames": int(d.size)}


def layer_trace(model, dev) -> dict:
    """C3's trace: one full batch (host-normalized) through the model's
    forward in bf16 with the kernels and eager, and eager in float32; for
    each bf16 arm the relative L2 error from float32 of the output of each
    conv layer (``conv0`` .. ``conv6``, the fused conv function's calls in
    order), of the hidden state after the feature projection, after each
    encoder layer (the input of the next layer's first LayerNorm; the last
    layer's the encoder's output) and of the head's logits.  No rounding
    point changes: the model's own functions are wrapped to read their
    values."""
    from wav2vecsegmenter_tpu_torch.data.collate import collate, out_len_for
    from wav2vecsegmenter_tpu_torch.models import wav2vec2 as w2v

    batch = collate(full_batch_examples(), B, L_AUDIO, out_len_for(L_AUDIO))
    a, n, m = (torch.from_numpy(x).to(dev) for x in (
        batch.audio, batch.in_lengths, batch.out_mask))
    layers = model.backbone.encoder.layers
    proj = model.backbone.feature_projection.projection
    first_ln = {id(layer.layer_norm.weight): i
                for i, layer in enumerate(layers)}
    real = {f: getattr(w2v, f) for f in ("_lin", "layer_norm", "encoder",
                                          "conv_bias_ln_gelu")}
    states: list = []

    def conv_(*args, **kw):
        out = real["conv_bias_ln_gelu"](*args, **kw)
        states.append((f"conv{sum(k.startswith('conv') for k, _ in states)}",
                       out))
        return out

    def lin(lin_, x, dt):
        out = real["_lin"](lin_, x, dt)
        if lin_ is proj:
            states.append(("projection", out))
        return out

    def layer_norm_(x, weight, *args, **kw):
        i = first_ln.get(id(weight))
        if i:  # the input of layer i: layer i - 1's output
            states.append((f"layer{i - 1}", x))
        return real["layer_norm"](x, weight, *args, **kw)

    def encoder_(*args, **kw):
        out = real["encoder"](*args, **kw)
        states.append((f"layer{len(layers) - 1}", out))
        return out

    def run(mode, dtype):
        states.clear()
        backend.set_kernels(mode)
        with torch.inference_mode():
            logits = model(a, n, m, dtype)
        backend.set_kernels("auto")
        return [(k, v.float()) for k, v in states] + [("head", logits)]

    for f, fn in (("_lin", lin), ("layer_norm", layer_norm_),
                  ("encoder", encoder_), ("conv_bias_ln_gelu", conv_)):
        setattr(w2v, f, fn)
    try:
        ref = run("eager", torch.float32)
        out = {}
        for arm, mode in (("kernels", "auto"), ("eager", "eager")):
            got = run(mode, torch.bfloat16)
            check([k for k, _ in got] == [k for k, _ in ref],
                  f"layer trace: {[k for k, _ in got]}")
            out[arm] = {k: float((x - r).norm() / r.norm())
                        for (k, x), (_, r) in zip(got, ref)}
            del got
    finally:
        for f, fn in real.items():
            setattr(w2v, f, fn)
    del ref
    torch.cuda.empty_cache()
    return out


def run_precision(dev, model) -> dict:
    """The precision ladder (``runtime.precision``) on one full batch of 14
    x 20 s with the kernels, each arm against the eager float32 path (the
    oracle): |dprob| over the valid frames, the batch's wall ms (five
    runs) and device busy ms (three, profiled), and its launches; for the
    f32 arm also one batch's top device ops and kernels (``op_profile``)."""
    from wav2vecsegmenter_tpu_torch.infer.pipeline import (PRECISION_ARMS,
                                                           WindowInference)

    batch = full_batch()
    backend.set_kernels("eager")
    oracle = WindowInference(model, dev, torch.float32).run_batch(
        batch).numpy()
    backend.set_kernels("auto")
    want = batch_launches(model)
    arms = {}
    for arm in PRECISION_ARMS:
        engine = WindowInference(model, dev, torch.bfloat16, arm)

        def run():
            return engine.run_batch(batch).numpy()

        run()  # warm-up
        backend.reset_launch_counts()
        probs = run()
        launches = {k: v for k, v in backend.launch_counts().items() if v}
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        arms[arm] = {
            "dprob_vs_f32_eager": dprob_stats(
                np.abs(probs - oracle)[batch.out_mask]),
            "batch_ms": walls, "batch_ms_median": float(np.median(walls)),
            "device_busy_ms": device_busy_ms(run, 3), "launches": launches}
        if arm == "f32":  # where the float32 batch's device time goes
            arms[arm].update(op_profile(run))
    phase("precision", windows=B, oracle="eager float32", arms=arms,
          layer_rel_err=layer_trace(model, dev))
    for arm, row in arms.items():
        check(row["launches"] == want,
              f"precision {arm}: launches {row['launches']}, not {want}")
    f32 = arms["f32"]["dprob_vs_f32_eager"]
    for q in ("mean", "p99"):
        check(f32[q] <= F32_ATOL,
              f"precision f32: {q} dprob {f32[q]} from the eager float32 "
              f"path beyond {F32_ATOL}")
    res, low = (arms[a]["dprob_vs_f32_eager"]["mean"]
                for a in ("f32res", "bf16"))
    check(res < low, f"precision: f32res mean dprob {res} not below bf16's "
                     f"{low}")
    return arms


# the f32 arm's device time by kernel group (names as
# ops/timing.device_kernels_ms shortens them): K5, the conv layers (1-6 on
# split TF32, the raw-audio layer 0), the attention forward (K3, K4), the
# weights' split, the LayerNorms; the rest is PyTorch's
F32_ARM_GROUPS = {"ffn": ("ffn_tf32_kernel",),
                  "conv_layers_1_6": ("conv_tf32_kernel",),
                  "conv_layer_0": ("conv_audio_f32_kernel",),
                  "attention": ("attn_fwd_f32_kernel",),
                  "weight_split": ("tf32_split_kernel",),
                  "layer_norm": ("ln_rows_kernel",)}


def op_profile(fn, n: int = 12) -> dict:
    """One call traced (CPU and CUDA activity): its ``n`` host ops and
    ``n`` device kernels of most device time (ms; every kernel launched
    through ctypes falls outside any host op), and the kernels' time by
    ``F32_ARM_GROUPS``."""
    from torch.profiler import ProfilerActivity, profile

    from wav2vecsegmenter_tpu_torch.ops.timing import (device_kernels_ms,
                                                        top_device_ops)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels_ms(prof)
    groups = {g: sum(ms for k, ms in kernels.items() if k in names)
              for g, names in F32_ARM_GROUPS.items()}
    groups["rest"] = sum(kernels.values()) - sum(groups.values())
    return {"top_device_ops": top_device_ops(prof, n),
            "top_device_kernels": dict(list(kernels.items())[:n]),
            "device_kernel_groups": groups,
            "device_kernels_total": sum(kernels.values())}


# the four int8 products of an encoder layer on a batch of 14 x 20 s
# windows, (rows, in, out): QKV, the attention output, FFN w1 and w2
INT8_PRODUCTS = {"qkv": (B * T, 1024, 3072), "o": (B * T, 1024, 1024),
                 "w1": (B * T, 1024, 4096), "w2": (B * T, 4096, 1024)}
INT8_STREAM_SECS = 120.0


def int8_split(engine, batch) -> dict:
    """One int8 batch traced: its device busy ms, split into ``_int_mm``,
    the activations' quantization (``ops.quant.quantize_rows``), the rest
    of the int8 layers (dequantization: the int32 cast, the two scales,
    the cast to the compute dtype and the bias) and everything else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from wav2vecsegmenter_tpu_torch.models import wav2vec2 as w2v
    from wav2vecsegmenter_tpu_torch.ops import quant
    from wav2vecsegmenter_tpu_torch.ops.timing import busy_ms

    def annotated(name, fn):
        def run(*args):
            with record_function(name):
                return fn(*args)
        return run

    real = quant.quantize_rows, w2v.int8_linear
    quant.quantize_rows = annotated("int8_quantize", real[0])
    w2v.int8_linear = annotated("int8_linear", real[1])
    try:
        engine.run_batch(batch).numpy()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.run_batch(batch).numpy()
            torch.cuda.synchronize()
    finally:
        quant.quantize_rows, w2v.int8_linear = real
    ms = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            ms[e.key] = getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0.0)) / 1e3
    busy = busy_ms(prof)
    mm, qz, lin = (ms.get(k, 0.0) for k in ("aten::_int_mm", "int8_quantize",
                                            "int8_linear"))
    return {"device_busy_ms": busy, "int_mm_ms": mm, "quantize_ms": qz,
            "dequantize_ms": lin - qz - mm, "rest_ms": busy - lin}


def int8_products(dev) -> dict:
    """Each int8 product of an encoder layer alone at the full batch's
    shapes (bf16 activations, seeded): ``_int_mm`` against the bf16
    ``torch.matmul`` of the same operands, and the whole int8 layer
    (quantize, product, dequantize, bias) against the bf16 ``F.linear``,
    each beside its bound at the int8 and the bf16 peak.  The int32 sums
    must equal a float64 product of the int8 operands."""
    from wav2vecsegmenter_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    for name, (m, k, n) in INT8_PRODUCTS.items():
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        w = torch.randn(n, k, device=dev, generator=g) * k ** -0.5
        b = torch.randn(n, device=dev, generator=g) * 0.1
        q = quant.quantize_linear(w, b)
        xq, _ = quant.quantize_rows(x)
        sums = quant.int8_mm(xq, q.qw)
        check(torch.equal(sums.double(), xq.double() @ q.qw.double().t()),
              f"int8 {name}: _int_mm sums differ from the exact product")
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        ops = 2.0 * m * k * n
        int8_bound = bound(m * k + n * k + 4 * m * n, ("int8_tc", ops))
        bf16_bound = bound(2 * (m * k + n * k + m * n), ("bf16_tc", ops))
        rows[name] = {
            "shape": [m, k, n],
            "int_mm_ms": cuda_ms(lambda: quant.int8_mm(xq, q.qw), 20),
            "bf16_matmul_ms": cuda_ms(lambda: torch.matmul(x, wb.t()), 20),
            "int8_layer_ms": cuda_ms(
                lambda: quant.int8_linear(x, q, torch.bfloat16), 20),
            "bf16_linear_ms": cuda_ms(lambda: F.linear(x, wb, bb), 20),
            "int8_bound_ms": int8_bound[0], "int8_bound_by": int8_bound[1],
            "bf16_bound_ms": bf16_bound[0], "bf16_bound_by": bf16_bound[1]}
    return rows


def run_int8(dev, model) -> dict:
    """``runtime.quantize=int8`` on the card: the precision phase's batch
    in bf16 with the kernels, at the default arm and at f32res, against
    the eager float32 path, the bf16 path and the int8 eager path, with
    its launches (no fused FFN: K5 must not launch; the rest as on the
    default path); the int8 and bf16 batches' wall and device ms in
    turns; the int8 batch's device split; the four products alone; one
    online stream at batch 1."""
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference

    t0 = time.perf_counter()
    batch = full_batch()
    mask = batch.out_mask
    backend.set_kernels("eager")
    oracle = WindowInference(model, dev, torch.float32).run_batch(
        batch).numpy()
    backend.set_kernels("auto")
    bf16 = WindowInference(model, dev, torch.bfloat16)
    probs_bf16 = bf16.run_batch(batch).numpy()
    want = {k: v for k, v in batch_launches(model).items() if k != "ffn"}

    def dprob(a, b):
        return dprob_stats(np.abs(a - b)[mask])

    arms, engines = {}, {}
    for arm in ("bf16", "f32res"):
        engines[arm] = engine = WindowInference(model, dev, torch.bfloat16,
                                                arm, "int8")
        engine.run_batch(batch).numpy()  # warm-up
        backend.reset_launch_counts()
        probs = engine.run_batch(batch).numpy()
        launches = {k: v for k, v in backend.launch_counts().items() if v}
        backend.set_kernels("eager")
        probs_eager = engine.run_batch(batch).numpy()
        backend.set_kernels("auto")
        arms[arm] = {"dprob_vs_f32_eager": dprob(probs, oracle),
                     "dprob_eager_vs_f32_eager": dprob(probs_eager, oracle),
                     "dprob_vs_bf16": dprob(probs, probs_bf16),
                     "dprob_vs_int8_eager": dprob(probs, probs_eager),
                     "launches": launches}

    walls = {"bf16": [], "int8": []}
    runs = {"bf16": bf16, "int8": engines["bf16"]}
    for name in ("bf16", "int8", "int8", "bf16", "bf16", "int8"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs[name].run_batch(batch).numpy()
        walls[name].append((time.perf_counter() - t1) * 1e3)
    busy = {name: device_busy_ms(lambda: e.run_batch(batch).numpy(), 3)
            for name, e in runs.items()}
    split = int8_split(engines["bf16"], batch)
    products = int8_products(dev)

    # one online stream at batch 1, int8 and bf16
    audio = talk_pcm(INT8_STREAM_SECS, 20).astype(np.float32) / 32768.0
    stream = {}
    for name, engine in runs.items():
        timed = TimedEngine(engine)
        segs, wall = stream_once(timed, audio, **PTHR_ONLINE)
        stream[name] = {"windows": len(timed.calls),
                        "window_wall_ms": spread([ms for _, ms in
                                                  timed.calls]),
                        "audio_per_wall": INT8_STREAM_SECS / wall,
                        "segments": len(segs)}
    phase("int8", windows=B, oracle="eager float32", arms=arms,
          batch_ms=walls,
          batch_ms_median={k: float(np.median(v)) for k, v in walls.items()},
          device_busy_ms=busy, int8_device_split=split, products=products,
          online_stream_secs=INT8_STREAM_SECS, online=stream,
          seconds=time.perf_counter() - t0)
    for arm, row in arms.items():
        check(row["launches"] == want,
              f"int8 {arm}: launches {row['launches']}, not {want} "
              f"(no ffn)")
        for q in ("mean", "p99"):
            got = row["dprob_vs_f32_eager"][q]
            ref = row["dprob_eager_vs_f32_eager"][q]
            check(got <= KERNEL_SLACK * ref,
                  f"int8 {arm}: the kernels add error: {q} dprob to "
                  f"float32 {got} vs {ref} on the int8 eager path")
    check(stream["int8"]["segments"] > 0, "int8 online stream committed "
                                          "nothing")
    return arms


# cross-talk packing: the slice's two talks and three more whose 20 s grids
# end in partial batches
PACK_TALKS = {"talk1.wav": 65.0, "talk2.wav": 41.0, "talk3.wav": 33.0,
              "talk4.wav": 87.5, "talk5.wav": 52.3}
# tests/test_packing.py's bounds, from the JAX package on the CPU at
# float32: a packed sweep's probabilities within 1.5 times the batch-size
# envelope of the per-talk sweep's, its yaml rows one row more or fewer
# and, in order, offsets one 0.06 s trim step apart, durations two
PACK_ENV_SLACK, PACK_OFFSET_S, PACK_DURATION_S = 1.5, 0.06, 0.12


def row_gap(rows_a: list, rows_b: list, talks=None) -> dict:
    """Two sweeps' yaml rows talk by talk (``talks``: PACK_TALKS by
    default): rows that differ, rows whose pair in order lies beyond
    tests/test_packing.py's offset and duration bounds, and the largest
    difference in a talk's row count."""
    gap = {"differing": 0, "beyond_bounds": 0, "count_gap": 0}
    for name in talks or PACK_TALKS:
        a, b = ([r for r in rows if r["wav"] == name]
                for rows in (rows_a, rows_b))
        gap["count_gap"] = max(gap["count_gap"], abs(len(a) - len(b)))
        gap["differing"] += sum(x != y for x, y in zip(a, b)) + abs(
            len(a) - len(b))
        gap["beyond_bounds"] += sum(
            abs(x["offset"] - y["offset"]) > PACK_OFFSET_S + 1e-9
            or abs(x["duration"] - y["duration"]) > PACK_DURATION_S + 1e-9
            for x, y in zip(a, b))
    return gap


def run_packing(dev, model) -> dict:
    """``runtime.pack_across_talks`` through ``segment_wavs`` at batch 14
    in bf16 with the kernels: five talks packed and per talk, in turns
    (batches and wall), against the batch-size deviation class, the
    per-talk sweep at batches 1 and 3, and at 14 without the remainder
    ladder (every batch 14 rows, as packed), against batch 14: each talk's
    max |dprob| packed within PACK_ENV_SLACK of that envelope's, and the
    yaml rows packed no further from the per-talk sweep's (rows beyond
    tests/test_packing.py's bounds, a talk's row count) than those
    sweeps' rows are."""
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference

    t0 = time.perf_counter()
    counted = [0]
    real = WindowInference.run_batch

    def run_batch(self, batch, need_logits=False):
        counted[0] += 1
        return real(self, batch, need_logits)

    with tempfile.TemporaryDirectory() as tmp:
        wavs = [Path(tmp) / name for name in PACK_TALKS]
        for seed, w in enumerate(wavs):
            write_talk(w, PACK_TALKS[w.name], seed)

        def sweep(pack: bool, batch_size: int = B, ladder: bool = True):
            probs: dict = {}
            counted[0] = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = segment_wavs(model, wavs, PTHR, batch_size, 20.0, 1, dev,
                                torch.bfloat16, remainder_ladder=ladder,
                                talk_probs=probs, pack_across_talks=pack)
            torch.cuda.synchronize()
            return rows, probs, time.perf_counter() - t1, counted[0]

        WindowInference.run_batch = run_batch
        try:
            out = {True: sweep(True), False: sweep(False)}  # warm-up
            walls = {True: [], False: []}
            for pack in (True, False, False, True, True, False):
                out[pack] = sweep(pack)
                walls[pack].append(out[pack][2])
            other = {str(bs): sweep(False, bs) for bs in (1, 3)}
            other[f"{B}_no_ladder"] = sweep(False, B, ladder=False)
        finally:
            WindowInference.run_batch = real
    rows_p, probs_p, _, n_p = out[True]
    rows_u, probs_u, _, n_u = out[False]
    talks = {}
    for name in PACK_TALKS:
        check(bool(np.isfinite(probs_p[name]).all()), "non-finite probs")
        talks[name] = {
            "max_abs_dprob": float(np.abs(probs_p[name] - probs_u[name])
                                   .max()),
            "envelope": max(float(np.abs(probs_u[name] - o[1][name]).max())
                            for o in other.values())}
    gap = row_gap(rows_p, rows_u)
    env_gap = {bs: row_gap(o[0], rows_u) for bs, o in other.items()}
    phase("packing", reader_backend=native_reads(),
          talks=len(PACK_TALKS), audio_secs=sum(PACK_TALKS.values()),
          batch_size=B, batches_packed=n_p, batches_per_talk=n_u,
          wall_s_packed=walls[True], wall_s_per_talk=walls[False],
          dprob_by_talk=talks, rows_packed=len(rows_p),
          rows_per_talk=len(rows_u), rows_vs_per_talk=gap,
          rows_batch_size_vs_14=env_gap, seconds=time.perf_counter() - t0)
    check(n_p < n_u, f"packing ran {n_p} batches, per talk {n_u}")
    check({r["wav"] for r in rows_p} == set(PACK_TALKS),
          "packing: a talk got no segments")
    for name, t in talks.items():
        check(t["max_abs_dprob"] <= PACK_ENV_SLACK * t["envelope"],
              f"packing: {name} max |dprob| {t['max_abs_dprob']} beyond "
              f"{PACK_ENV_SLACK} x the batch-size envelope {t['envelope']}")
    for key in ("beyond_bounds", "count_gap"):
        worst = max(g[key] for g in env_gap.values())
        check(gap[key] <= worst,
              f"packing: rows {key} {gap[key]}, beyond the batch-size "
              f"class's {worst}")
    return talks


# online serving: streams of 10 min fed in 0.5 s chunks, 20 s windows (the
# segment path's), eight streams at once through MultiStreamSegmenter's
# slots of up to eight windows: 30 batches of 8
ONLINE_SECS, ONLINE_STREAMS, ONLINE_CHUNK = 600.0, 8, 8000
ONLINE_W = 320000  # samples of a window
# conf/algorithm/strm.yaml: the server check's algorithm, whose decisions
# are each frame's probability against the threshold
STRM = {"algorithm": "strm", "max_segment_length": 18,
        "min_segment_length": 0.2, "min_pause_length": 0.2, "threshold": 0.5}
PTHR_ONLINE = {"algorithm": "pthr",
               **{k: v for k, v in PTHR.items() if k != "tag"}}


class TimedEngine:
    """An engine that records each batch's slots and its wall ms from
    dispatch to the host's read of its probabilities."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []

    def run_batch(self, batch):
        return _TimedHandle(self, len(batch.included), time.perf_counter(),
                            self.engine.run_batch(batch))


class _TimedHandle:
    def __init__(self, timed, slots, t0, handle):
        self.timed, self.slots, self.t0, self.handle = timed, slots, t0, handle

    def numpy(self):
        out = self.handle.numpy()
        self.timed.calls.append((self.slots,
                                 (time.perf_counter() - self.t0) * 1e3))
        return out


def stream_once(engine, audio: np.ndarray, **kw):
    """One stream through an OnlineSegmenter in 0.5 s chunks: (segments,
    wall s)."""
    from wav2vecsegmenter_tpu_torch.infer.online import OnlineSegmenter

    seg = OnlineSegmenter(engine, segment_length=20.0, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(audio), ONLINE_CHUNK):
        seg.feed(audio[i: i + ONLINE_CHUNK])
    seg.finish()
    torch.cuda.synchronize()
    return ([(s.offset, s.duration) for s in seg.segments],
            time.perf_counter() - t0)


def mux_once(engine, streams: list, **kw):
    """The streams at once through a MultiStreamSegmenter (max_batch 8),
    a 0.5 s chunk of each a round: (segments of each, wall s)."""
    from wav2vecsegmenter_tpu_torch.infer.online import MultiStreamSegmenter

    mux = MultiStreamSegmenter(engine, max_batch=8, segment_length=20.0,
                               **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, max(len(a) for a in streams), ONLINE_CHUNK):
        mux.feed({k: a[i: i + ONLINE_CHUNK] for k, a in enumerate(streams)
                  if i < len(a)})
    mux.finish_all()
    torch.cuda.synchronize()
    return ([[(s.offset, s.duration) for s in mux.segments(k)]
             for k in range(len(streams))], time.perf_counter() - t0)


def profiled(fn):
    """(fn's result, device busy ms, wall ms) of one call traced for
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    from wav2vecsegmenter_tpu_torch.ops.timing import busy_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, busy_ms(prof), wall


def host_profile(fn) -> dict:
    """One call traced (CPU and CUDA activity): its device busy ms, and the
    eight host ops of most self time (ms, the calls summed)."""
    from torch.profiler import ProfilerActivity, profile

    from wav2vecsegmenter_tpu_torch.ops.timing import busy_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host = sorted(((e.key, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    return {"traced_device_busy_ms": busy_ms(prof),
            "host_top_ms": dict(host[:8]),
            "host_total_ms": sum(ms for _, ms in host)}


def boundary_diff(a: list, b: list) -> int:
    """Segment boundaries (starts and ends, to 1e-4 s) in one list and not
    the other."""
    def marks(segs):
        return ({round(o, 4) for o, _ in segs}
                | {round(o + d, 4) for o, d in segs})
    return len(marks(a) ^ marks(b))


# the functions the model's modules call that may make a row's result hang
# on the batch: the kernels' wrappers, every linear layer (cuBLAS) and the
# positional conv (cuDNN); what lies between them is element-wise
INVARIANCE_HOOKS = {
    "wav2vec2": ("conv_bias_ln_gelu", "layer_norm", "positional_conv",
                 "attention_packed", "ffn", "_lin"),
    "sfc": ("layer_norm", "attention_qkv", "_lin", "output_layer")}


def invariance_ops(model, batch) -> dict:
    """Batch invariance op by op, on the model's own forward (bf16, the
    kernels): one run of the collated batch of eight windows records each
    hooked call's first tensor input and its output; then each window runs
    alone with every hooked call's output replaced by its row of the
    batched output, so that each call sees what it saw batched.  For each
    op (a linear layer by its module's name, layer indices folded): the
    max |difference| of its output over its calls and the eight windows,
    and of its input, which only the unhooked code before it can make (the
    QKV and the head's in-projection, plain matmuls); 0 where bitwise."""
    import re

    from wav2vecsegmenter_tpu_torch.models import sfc
    from wav2vecsegmenter_tpu_torch.models import wav2vec2 as w2v

    mods = {"wav2vec2": w2v, "sfc": sfc}
    names = {id(m): re.sub(r"\.\d+\.", ".*.", n)
             for n, m in model.named_modules()}
    calls, ops, state = [], {}, {"window": None, "i": 0}

    def hook(fname, fn):
        def hooked(*args, **kw):
            x = next(a for a in args if isinstance(a, torch.Tensor))
            op = (f"{fname} {names[id(args[0])]}"
                  if fname in ("_lin", "output_layer") else fname)
            out = fn(*args, **kw)
            k = state["window"]
            if k is None:
                calls.append((op, x, out))
                return out
            want_op, bx, bout = calls[state["i"]]
            state["i"] += 1
            check(op == want_op, f"invariance: call {op}, batched {want_op}")
            row = ops.setdefault(op, {"calls": 0, "input": 0.0,
                                      "output": 0.0})
            row["calls"] += k == 0
            for key, got, ref in (("input", x, bx), ("output", out, bout)):
                row[key] = max(row[key], (got[0].float() - ref[k].float())
                               .abs().max().item())
            return bout[k:k + 1]
        return hooked

    saved = [(mods[m], f, getattr(mods[m], f))
             for m, fs in INVARIANCE_HOOKS.items() for f in fs]
    for mod, f, fn in saved:
        setattr(mod, f, hook(f, fn))
    try:
        with torch.inference_mode():
            dev = next(model.parameters()).device
            a, n, m = (torch.from_numpy(x).to(dev) for x in (
                batch.audio, batch.in_lengths, batch.out_mask))
            model(a, n, m, torch.bfloat16)
            for k in range(len(a)):
                state.update(window=k, i=0)
                model(a[k:k + 1], n[k:k + 1], m[k:k + 1], torch.bfloat16)
                check(state["i"] == len(calls),
                      f"invariance: window {k} made {state['i']} calls, "
                      f"batched {len(calls)}")
    finally:
        for mod, f, fn in saved:
            setattr(mod, f, fn)
    return {"ops": ops,
            "outputs_differ": [op for op, r in ops.items() if r["output"]],
            "inputs_differ": [op for op, r in ops.items() if r["input"]]}


# the synthetic-data tool's stage 1: its pDAC tree's settings, the CLI's
# defaults but the depth.  The tree keeps its binary-heap layout, so every
# level doubles its nodes: at the default depth of 20 a talk's tree holds
# 2^21 - 1 nodes and takes about a minute of host time; at 8, 511.
TREE = {"max_segment_length": 18, "min_segment_length": 0.2,
        "boundary_threshold": 0.5, "trim_threshold": 0.0, "tree_depth": 8}


def run_stage1(dev, model) -> dict:
    """The st phase's (a): the synthetic-data tool's stage 1 device part
    (``cli.prepare_synthetic_data.tree_rows``: WindowInference over whole
    talks at batch 14, one talk dispatched ahead, the passes averaged,
    then the pDAC tree) on the slice's two talks, at inference_times 1 and
    2: bf16 with the kernels (launch counters reset just before the first),
    bf16 eager (counters unmoved) and float32 with the kernels.  The slice
    phase's rules: the kernels' probabilities as close to float32 as the
    eager path's (within KERNEL_SLACK) and no further from eager than bf16
    is from float32; every talk in the tree rows and in tree.length."""
    from wav2vecsegmenter_tpu_torch.cli.prepare_synthetic_data import (
        tree_rows)

    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        secs = {"talk1.wav": 65.0, "talk2.wav": 41.0}
        wavs = [Path(tmp) / name for name in secs]
        for seed, w in enumerate(wavs):
            write_talk(w, secs[w.name], seed)

        def run(mode, dtype, times):
            backend.set_kernels(mode)
            before = backend.launch_counts()
            probs: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows, lengths = tree_rows(model, wavs, dev, dtype, B, 20.0, times,
                                      **TREE, talk_probs=probs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            backend.set_kernels("auto")
            if mode == "eager":
                check(backend.launch_counts() == before,
                      "stage 1: the eager run launched kernels")
            check([n for n, _ in lengths] == list(secs)
                  and {r["wav"] for r in rows} == set(secs),
                  f"stage 1: a talk without a tree: {lengths}")
            for name, p in probs.items():
                check(p.shape == (round(secs[name] * 49.95),)
                      and bool(np.isfinite(p).all()), "stage 1: probs")
            return rows, lengths, probs, wall

        run("auto", torch.bfloat16, 1)  # warm-up
        backend.reset_launch_counts()
        for times in (1, 2):
            k = run("auto", torch.bfloat16, times)
            if times == 1:
                launches = backend.launch_counts()
            e = run("eager", torch.bfloat16, times)
            f = run("auto", torch.float32, times)

            def dprob(a, b):
                d = np.concatenate([np.abs(a[2][w] - b[2][w]) for w in secs])
                return {"mean": float(d.mean()),
                        "p99": float(np.percentile(d, 99)),
                        "max": float(d.max())}

            k_vs_f, e_vs_f, k_vs_e = dprob(k, f), dprob(e, f), dprob(k, e)
            audio = sum(secs.values()) * times
            out[f"times_{times}"] = {
                "tree_rows": {"kernels": len(k[0]), "eager": len(e[0]),
                              "f32": len(f[0])},
                "tree_length": {"kernels": dict(k[1]), "eager": dict(e[1]),
                                "f32": dict(f[1])},
                "rows_differing_kernels_vs_eager": sum(
                    a != b for a, b in zip(k[0], e[0])) + abs(
                    len(k[0]) - len(e[0])),
                "dprob_kernels_vs_f32": k_vs_f, "dprob_eager_vs_f32": e_vs_f,
                "dprob_kernels_vs_eager": k_vs_e,
                "wall_s": {"kernels": k[3], "eager": e[3], "f32": f[3]},
                "audio_per_wall_kernels": audio / k[3],
                "audio_per_wall_eager": audio / e[3]}
            for q in ("mean", "p99"):
                check(k_vs_f[q] <= KERNEL_SLACK * e_vs_f[q],
                      f"stage 1 (times {times}): kernels add error: {q} "
                      f"dprob to float32 {k_vs_f[q]} vs {e_vs_f[q]}")
                check(k_vs_e[q] <= e_vs_f[q],
                      f"stage 1 (times {times}): kernel vs eager {q} dprob "
                      f"{k_vs_e[q]} beyond the bf16 envelope {e_vs_f[q]}")
    for name in INFER_PATH:
        check(launches.get(name, 0) > 0,
              f"kernel {name} never launched in stage 1")
    out["launches_times_1"] = launches
    return out


def st_eval_check(dev, model, generator, ckpt: Path, root: Path) -> dict:
    """The st phase's (b): the in-training ST evaluation's device part
    (``train.loop.st_eval_segments``) with the train phase's live model, in
    train mode as the trainer leaves it, for conf/st_eval's pDAC and pTHR
    at batch 1 over two talks of the train corpus: the model back in train
    mode, the trainer's dropout generator and the global generators
    untouched, and the rows equal to ``segment_wavs``'s on the checkpoint
    the trainer saved, loaded into a fresh model."""
    from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
        load_reference_checkpoint)
    from wav2vecsegmenter_tpu_torch.cli.common import build_model
    from wav2vecsegmenter_tpu_torch.config import Config, merge
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu_torch.train.loop import st_eval_segments

    t_start = time.perf_counter()
    wav_dir = root / "st_wavs"
    wav_dir.mkdir()
    for i in range(2):
        write_talk(wav_dir / f"talk{i}.wav", TRAIN_SECS, seed=10 + i)
    base = {"batch_size": 1, "inference_segment_length": 20,
            "inference_times": 1, "infer_data": {"wav_dir": str(wav_dir)}}
    config = merge(Config(), {
        "st_eval": {**base, "algorithm": DAC},
        "st_eval_online": {**base, "algorithm": {"tag": "pthr", **{
            k: v for k, v in PTHR.items() if k != "tag"}}}})
    engine = WindowInference(model, dev, torch.bfloat16, loss_tag="bce")
    model.train()
    state = (generator.get_state(), torch.get_rng_state(),
             torch.cuda.get_rng_state())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segs = st_eval_segments(config, model, engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(model.training, "st eval: the model did not go back to train mode")
    check(all(torch.equal(a, b) for a, b in zip(state, (
        generator.get_state(), torch.get_rng_state(),
        torch.cuda.get_rng_state()))), "st eval: a generator moved")
    fresh, _ = build_model(SHAS_TASK["model"], dev)
    init_from_numpy(fresh, seed=0)
    load_reference_checkpoint(ckpt, fresh, allow_random_wav2vec=True)
    fresh.eval()
    out = {"wall_s": wall, "talks": 2, "audio_secs": 2 * TRAIN_SECS}
    for key, (tag, rows) in segs.items():
        algo = dict(config[key].algorithm)
        want = segment_wavs(fresh, sorted(wav_dir.glob("*.wav")), algo, 1,
                            20.0, 1, dev, torch.bfloat16)
        check(rows == want, f"st eval {key}: the live model's rows differ "
                            f"from the saved checkpoint's")
        out[key] = {"algorithm": tag, "segments": len(rows)}
    check(list(segs) == ["st_eval", "st_eval_online"],
          f"st eval: keys {list(segs)}")
    del fresh
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out


def spread(xs: list) -> dict:
    return {"n": len(xs), "median": float(np.median(xs)),
            "min": float(min(xs)), "max": float(max(xs))}


def run_online(dev, model) -> dict:
    """Online serving on the card (bf16, the kernels): first calls per slot
    size; batch invariance; then, launches counted from here on, one
    stream at batch 1, tumbling and with a 2 s hop; eight concurrent
    streams through MultiStreamSegmenter, three times; a
    SegmentationServer with eight clients and a drain.  Returns the
    launches of those serving runs alone."""
    from wav2vecsegmenter_tpu_torch.core.frames import inframes_to_outframes
    from wav2vecsegmenter_tpu_torch.data.collate import collate, out_len_for
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference

    engine = WindowInference(model, dev, torch.bfloat16)
    pcm = [talk_pcm(ONLINE_SECS, 20 + k) for k in range(ONLINE_STREAMS)]
    audio = [p.astype(np.float32) / 32768.0 for p in pcm]
    out_len = out_len_for(ONLINE_W)
    span = int(inframes_to_outframes(ONLINE_W))  # 999 frames a window
    n_windows = len(audio[0]) // ONLINE_W

    def windows(k):
        return [(audio[k][j * ONLINE_W:(j + 1) * ONLINE_W], None, 0, span)
                for j in range(n_windows)]

    # (1) the first call at each slot size, then two more, then one traced:
    # its device busy ms and the host ops of most self time
    first = {}
    for slots in (1, 2, 4, 8):
        batch = collate([windows(k)[0] for k in range(slots)], slots,
                        ONLINE_W, out_len)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run_batch(batch).numpy()
            ms.append((time.perf_counter() - t0) * 1e3)
        first[slots] = {"first_ms": ms[0], "then_ms": ms[1:],
                        **host_profile(lambda: engine.run_batch(
                            batch).numpy())}

    # (2) batch invariance: every window batched in 8 slots, as the
    # multiplexer runs them, and alone; then op by op on the first 8
    dmax, equal_by_slot, alone_probs = 0.0, [0] * 8, [[] for _ in audio]
    for j in range(n_windows):
        rows = [windows(k)[j] for k in range(ONLINE_STREAMS)]
        batch8 = collate(rows, 8, ONLINE_W, out_len)
        batched = engine.run_batch(batch8).numpy()
        for k, row in enumerate(rows):
            alone = engine.run_batch(collate([row], 1, ONLINE_W,
                                             out_len)).numpy()[0]
            alone_probs[k].append(alone[:span])
            d = np.abs(batched[k, :span] - alone[:span])
            dmax = max(dmax, float(d.max()))
            equal_by_slot[k] += int(not d.any())
        if j == 0:
            by_op = invariance_ops(model, batch8)
    alone_probs = [np.concatenate(p) for p in alone_probs]

    # the serving runs, and only they, count launches
    backend.reset_launch_counts()
    # (3) one stream at batch 1
    timed = TimedEngine(engine)
    single = {}
    for mode, kw in (("tumbling", {}), ("hop_2s", {"hop_secs": 2.0})):
        timed.calls.clear()
        segs, wall = stream_once(timed, audio[0], **PTHR_ONLINE, **kw)
        win_ms = [ms for _, ms in timed.calls]
        _, busy, pwall = profiled(
            lambda: stream_once(engine, audio[0], **PTHR_ONLINE, **kw))
        single[mode] = {
            "windows": len(win_ms), "window_wall_ms": spread(win_ms),
            "device_ms_per_window": busy / len(win_ms),
            "audio_per_wall": ONLINE_SECS / wall, "segments": len(segs),
            "profiled_wall_ms": pwall, "idle_share": 1 - busy / pwall}

    # (4) eight concurrent streams, three times, then once traced
    total_secs = ONLINE_SECS * ONLINE_STREAMS
    walls = []
    for _ in range(3):
        timed.calls.clear()
        segs_mux, wall = mux_once(timed, audio, **PTHR_ONLINE)
        walls.append(wall)
    slots = sorted({s for s, _ in timed.calls})
    _, busy, pwall = profiled(lambda: mux_once(engine, audio, **PTHR_ONLINE))
    multi = {"streams": ONLINE_STREAMS, "audio_secs": total_secs,
             "wall_s": walls,
             "audio_per_wall": spread([total_secs / w for w in walls]),
             "batches": {s: sum(1 for t, _ in timed.calls if t == s)
                         for s in slots},
             "batch_wall_ms": spread([ms for _, ms in timed.calls]),
             "device_busy_ms": busy, "profiled_wall_ms": pwall,
             "idle_share": 1 - busy / pwall,
             "segments": [len(s) for s in segs_mux]}
    solo = [stream_once(engine, a, **PTHR_ONLINE)[0] for a in audio]
    invariance = {
        "rows": n_windows * ONLINE_STREAMS,
        "rows_bitwise_equal_by_slot": equal_by_slot,
        "max_abs_dprob": dmax,
        "boundaries_differing": [boundary_diff(a, b)
                                 for a, b in zip(segs_mux, solo)],
        "by_op": by_op}

    # (5) the daemon: eight clients, then a drain
    server = serve_check(engine, pcm, audio, alone_probs, dmax)
    launches = backend.launch_counts()
    phase("online", reader_backend=native_reads(),
          chunk_secs=ONLINE_CHUNK / 16000, stream_secs=ONLINE_SECS,
          first_call=first, single=single, multi=multi,
          invariance=invariance, server=server,
          cudnn_benchmark=torch.backends.cudnn.benchmark, launches=launches)
    for name in INFER_PATH:
        check(launches.get(name, 0) > 0,
              f"kernel {name} never launched on the online path")
    # C18: the output layer's rows alone as batched, and so every window's
    # probabilities and every stream's commits
    head_out = {op: r["output"] for op, r in by_op["ops"].items()
                if op.startswith("output_layer")}
    check(bool(head_out) and not any(head_out.values()),
          f"online: the output layer hangs on the batch: {head_out}")
    check(dmax == 0 and equal_by_slot == [n_windows] * ONLINE_STREAMS,
          f"online: batched windows differ from alone (max |dprob| {dmax}, "
          f"rows bitwise equal by slot {equal_by_slot} of {n_windows})")
    check(segs_mux == solo,
          f"online: multiplexed commits differ from each stream alone: "
          f"{invariance['boundaries_differing']} boundaries")
    return launches


def serve_check(engine, pcm: list, audio: list, probs: list,
                dmax: float) -> dict:
    """A SegmentationServer on a localhost port (STRM) with one client
    thread a stream: every connection's segments against its stream run
    alone at batch 1, as many boundaries apart as two for each frame whose
    batch-1 probability lies within the batch-invariance figure ``dmax``
    of the threshold (none where the rows were bitwise equal); then a
    connection still streaming when the server shuts down gets its tail
    segments and its end line."""
    import socket
    import threading

    from wav2vecsegmenter_tpu_torch.infer.server import (
        SegmentationServer, segment_stream_client)

    near = [int((np.abs(p - STRM["threshold"]) <= dmax).sum()) if dmax
            else 0 for p in probs]
    truth = [stream_once(engine, a, **STRM)[0] for a in audio]
    srv = SegmentationServer(engine, port=0, max_batch=8, segment_length=20.0,
                             **STRM)
    errors: list = []

    def serve():
        try:
            srv.serve_forever(poll_s=0.005)
        except Exception as e:  # this phase fails on it below
            errors.append(e)

    loop = threading.Thread(target=serve, daemon=True)
    loop.start()
    lines: dict = {}

    def client(k):
        lines[k] = segment_stream_client(srv.address, pcm[k].tobytes(),
                                         name=f"c{k}",
                                         chunk_bytes=2 * ONLINE_CHUNK)

    clients = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(len(pcm))]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not errors, f"server: {errors}")
    check(not any(c.is_alive() for c in clients), "server: a client hung")
    differing = []
    for k in range(len(pcm)):
        end = lines[k][-1]
        check(end["type"] == "end" and end["name"] == f"c{k}"
              and abs(end["audio_secs"] - ONLINE_SECS) < 1e-3,
              f"server: connection {k} ended {end}")
        got = [(ln["offset"], ln["duration"]) for ln in lines[k]
               if ln["type"] == "segment"]
        differing.append(boundary_diff(got, truth[k]))
        check(differing[-1] <= 2 * near[k],
              f"server: connection {k} {differing[-1]} boundaries from its "
              f"stream alone, {near[k]} frames near the threshold")

    # a connection still streaming (no FIN) when the server shuts down
    live = pcm[0][: int(30.5 * 16000)]
    want = stream_once(engine, live.astype(np.float32) / 32768.0, **STRM)[0]
    before = srv.total_samples
    sock = socket.create_connection(tuple(srv.address))
    sock.sendall(b'{"name": "live"}\n' + live.tobytes())
    deadline = time.monotonic() + 60
    while srv.total_samples < before + len(live):
        check(time.monotonic() < deadline, "server: the live stream stalled")
        time.sleep(0.01)
    srv.shutdown()
    loop.join(timeout=60)
    check(not loop.is_alive() and not errors, f"server: no drain {errors}")
    buf = b""
    while True:
        data = sock.recv(1 << 16)
        if not data:
            break
        buf += data
    sock.close()
    drained = [json.loads(ln) for ln in buf.splitlines() if ln.strip()]
    got = [(ln["offset"], ln["duration"]) for ln in drained
           if ln["type"] == "segment"]
    check(drained[-1]["type"] == "end"
          and abs(drained[-1]["audio_secs"] - 30.5) < 1e-3,
          f"server: the drain ended {drained[-1]}")
    check(boundary_diff(got, want) <= 2 * near[0],
          "server: the drained stream's segments differ from its own run")
    return {"connections": len(pcm), "wall_s": wall,
            "audio_per_wall": ONLINE_SECS * len(pcm) / wall,
            "segments": [sum(ln["type"] == "segment" for ln in lines[k])
                         for k in range(len(pcm))],
            "boundaries_differing": differing, "near_threshold_frames": near,
            "drained_segments": len(got),
            "drained_boundaries_differing": boundary_diff(got, want)}


# conf/task/shas.yaml: the frozen-backbone task the trainer runs
SHAS_TASK = {
    "autoregression": False,
    "model": {"wav2vec_model_name": "facebook/wav2vec2-xls-r-300m",
              "wav2vec_keep_layers": 15, "finetune_wav2vec": False,
              "wav2vec_ft_layers": 99, "finetune_w2v_feat_enc": False,
              "finetune_w2v_ffn": False, "ffn_adapter": True,
              "n_transformer_enc_layers": 1, "n_transformer_enc_heads": 8,
              "init_dropout": 0.1},
    "train_generator": {"_target_": "lib.dataset.RandomDataloaderGenerator"},
    "eval_generator": {"inference_times": 1},
    "loss": {"_target_": "torch.nn.BCEWithLogitsLoss", "tag": "bce",
             "pos_weight": None, "ma_window": None, "reduction": "none"},
}
# six 100 s talks: 36 random 20 s windows an epoch, three micro-steps of 14
TRAIN_TALKS, TRAIN_SECS, TRAIN_WINDOW, TRAIN_STEPS = 6, 100.0, 20, 3


def write_corpus(root: Path, n_talks: int = TRAIN_TALKS,
                 texts: bool = False) -> tuple[str, str]:
    """Synthetic talks and their true segments (the speech bursts of
    write_talk), as the data prep writes the TSVs (an index column); with
    ``texts``, a ``tgt_text`` column of made-up transcripts (the CTC
    task's)."""
    talks = ["\tid\tpath\ttotal_frames"]
    segments = ["\ttalk_id\tstart\tend" + ("\ttgt_text" if texts else "")]
    words = "so we looked at the data and it was quite clear".split()
    for i in range(n_talks):
        path = root / f"talk{i}.wav"
        write_talk(path, TRAIN_SECS, seed=10 + i)
        talks.append(f"{i}\ttalk{i}\t{path}\t{int(TRAIN_SECS * 16000)}")
        for s0 in np.arange(0.0, TRAIN_SECS, 3.5):
            end = min(s0 + 3.0, TRAIN_SECS)
            text = ""
            if texts:
                k = len(segments) % len(words)
                text = "\t" + " ".join((words + words)[k:k + 5])
            segments.append(f"{len(segments) - 1}\ttalk{i}\t"
                            f"{int(s0 * 16000)}\t{int(end * 16000)}{text}")
    (root / "talks.tsv").write_text("\n".join(talks) + "\n")
    (root / "segments.tsv").write_text("\n".join(segments) + "\n")
    return str(root / "talks.tsv"), str(root / "segments.tsv")


def grad_dist(a, b) -> float:
    """Relative L2 distance of two gradient lists (b the reference)."""
    num = sum((x - y).square().sum() for x, y in zip(a, b))
    den = sum(y.square().sum() for y in b)
    return float(torch.sqrt(num / den))


def check_checkpoints(work: Path, out: dict, model) -> dict:
    """The kernels' train run's files (keep_last_ckpts=1, an eval and a
    checkpoint every TRAIN_STEPS micro-steps and at each epoch's end): on
    disk exactly the newest checkpoint, the best one (if any eval scored
    above 0), final.pt, and the run state, whose bookkeeping matches the
    loop's; the newest checkpoint loads through load_reference_checkpoint
    into the trained head.  Returns the bookkeeping."""
    from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
        load_reference_checkpoint)
    from wav2vecsegmenter_tpu_torch.checkpoints.io import load_run_state
    from wav2vecsegmenter_tpu_torch.cli.common import build_model

    names = [name for name, _ in out["evals"]]
    want = [f"epoch-{e}{s}" for e in range(2)
            for s in (f"_step-{TRAIN_STEPS * (e + 1)}", "")]
    check(names == want, f"train: evals {names}, not {want}")
    scores = [r["eval_f1"] for _, r in out["evals"]]
    book = out["checkpoints"]
    best = (f"{names[scores.index(max(scores))]}_best_eval_f1.pt"
            if max(scores) > 0 else None)
    check(book["ckpt_list"] == ["epoch-1.pt"] and book["best_checkpoint"]
          == best and book["best_score"] == max(max(scores), 0.0),
          f"train: bookkeeping {book}, evals {scores}")
    ckpts = work / "ckpts"
    on_disk = sorted(p.name for p in ckpts.iterdir())
    check(on_disk == sorted({"epoch-1.pt", "final.pt", best} - {None}),
          f"train: checkpoint files {on_disk}")
    state = load_run_state(work / "last_state")
    check(state is not None and state["epoch"] == 2
          and state["global_step"] == 2 * TRAIN_STEPS
          and {k: state[k] for k in book} == book,
          "train: the run state's bookkeeping")
    # the head's shapes need the backbone's width only: one layer of it
    back, _ = build_model({**SHAS_TASK["model"], "wav2vec_keep_layers": 1},
                          torch.device("cpu"))
    load_reference_checkpoint(ckpts / "epoch-1.pt", back,
                              allow_random_wav2vec=True)
    for key, value in model.seg_model.state_dict().items():
        check(torch.equal(back.seg_model.state_dict()[key], value.cpu()),
              f"train: epoch-1.pt's {key} is not the trained head's")
    return book


# the reader's steady state: one epoch of 18 micro-steps at batch 14, of
# which micro-steps [8, 12) are profiled for the device's busy time
STEADY_TALKS = 40
STEADY_PROFILED = (8, 12)


def _serial_iter(self):
    """``BatchIterator.__iter__`` without the reader: the batches read in
    the consumer's thread, as before the reader, timed as the reader times
    them."""
    self.read_seconds = reads = []
    t = time.perf_counter()
    for batch in self._serial_batches():
        reads.append(time.perf_counter() - t)
        yield batch
        t = time.perf_counter()


@contextlib.contextmanager
def serial_builder():
    """The loaders read serially (``_serial_iter``) inside the block."""
    from wav2vecsegmenter_tpu_torch.data.windows import BatchIterator

    threaded = BatchIterator.__iter__
    BatchIterator.__iter__ = _serial_iter
    try:
        yield
    finally:
        BatchIterator.__iter__ = threaded


@contextlib.contextmanager
def wave_reader():
    """The port's window reads take the stdlib ``wave`` route inside the
    block, as where the native loader cannot be built."""
    from wav2vecsegmenter_tpu_torch.data import audio

    saved = audio._native
    audio._native = False
    try:
        yield
    finally:
        audio._native = saved


def native_reads() -> str:
    """``data.audio.reader_backend()``, for a phase that reads wavs: it
    fails unless the native loader reads them."""
    from wav2vecsegmenter_tpu_torch.data.audio import reader_backend

    name = reader_backend()
    check(name == "native", f"the window reads take the {name} route, not "
                            f"the native loader's")
    return name


def reader_steady_state(dev, root: Path) -> dict:
    """One epoch of the train phase's bf16 kernels run over STEADY_TALKS
    talks three times: with the background reader on the native loader
    (``native``), with the reader on the stdlib ``wave`` route
    (:func:`wave_reader`) and with the serial builder (``serial``).  For
    each: the median ms a micro-step while the reads go on (the warm-up,
    the epoch's first, the last three micro-steps and those the profiler
    touches excluded) and after the reader has read the epoch's last batch
    (the last three), fetch and read ms over the first span.  In every run
    the profiler (device activity only) traces micro-steps
    STEADY_PROFILED: the device's busy ms a micro-step there, the host's
    wall of the same span and the device's idle share of it."""
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as prof_

    from wav2vecsegmenter_tpu_torch.ops.timing import busy_ms
    from wav2vecsegmenter_tpu_torch.train.loop import train

    root.mkdir()
    talks, segments = write_corpus(root, STEADY_TALKS)
    split = {"talk_list": talks, "segments_list": segments,
             "segment_length": TRAIN_WINDOW}
    first, end = STEADY_PROFILED

    def run(exp: str) -> dict:
        marks, busy = [], []

        def on_step(metrics):
            marks.append(time.perf_counter())
            p.step()

        # profiler step k spans micro-step k: from the k-th on_step to the
        # next; the warm-up step before the trace and the step after it,
        # which takes the trace's processing, are left out of the medians
        with prof_(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=first - 1, warmup=1,
                                     active=end - first, repeat=1),
                   on_trace_ready=lambda tr: busy.append(busy_ms(tr))) as p:
            out = train(train_config(dev, split, exp, "auto", "bfloat16",
                                     max_epochs=1), work_dir=root,
                        on_step=on_step)
        out.pop("model")
        torch.cuda.empty_cache()
        hist = {k: [t * 1e3 for t in v] for k, v in out["history"].items()
                if k.endswith("_seconds")}
        n = len(hist["step_seconds"])
        keep = [i for i in range(2, n - 3) if not first - 1 <= i <= end]

        def med(key, idx=keep):
            return float(np.median([hist[key][i] for i in idx]))

        wall = (marks[end - 1] - marks[first - 1]) * 1e3
        return {"micro_steps": n,
                "ms_per_micro_step": med("step_seconds"),
                "ms_per_micro_step_reader_done": med("step_seconds",
                                                     range(n - 3, n)),
                "fetch_ms": med("fetch_seconds"),
                "read_ms": med("read_seconds"),
                "profiled": {"device_busy_ms": busy[0] / (end - first),
                             "wall_ms": wall / (end - first),
                             "idle_share": 1 - busy[0] / wall},
                "step_ms": hist["step_seconds"]}

    native = run("steady_native")
    with wave_reader():
        wave_ = run("steady_wave")
    with serial_builder():
        serial = run("steady_serial")
    return {"profiled_micro_steps": [first, end], "native": native,
            "wave": wave_, "serial": serial}


def train_config(dev, split: dict, exp: str, mode: str, dtype: str,
                 **extra):
    """The train phase's run of conf/task/shas.yaml on ``split``: batch 14,
    two epochs, update_freq 2, seed 0, no checkpoints unless ``extra``
    asks."""
    from wav2vecsegmenter_tpu_torch.config import Config, merge

    return merge(Config(), {
        "exp_name": exp, "batch_size": B, "learning_rate": 2.5e-4,
        "max_epochs": 2, "update_freq": 2, "segment_length": TRAIN_WINDOW,
        "print_every_steps": 100, "save_ckpts": False, "task": SHAS_TASK,
        "data": {"train": split, "eval": split},
        "runtime": {"device": dev.type, "compute_dtype": dtype,
                    "kernels": mode, "seed": 0}, **extra})


def run_train(dev, profile: bool) -> tuple[dict, dict]:
    """The train phase; returns the launch counts of the kernels' bf16
    run and the st phase's (b), run on that run's model
    (:func:`st_eval_check`).  A fifth run, bf16 with the kernels, is profiled over micro-step
    PROFILED + 1 for the device's busy time (with ``profile``, its
    torch.profiler table goes to standard error)."""
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as prof_

    from wav2vecsegmenter_tpu_torch.cli.common import build_model
    from wav2vecsegmenter_tpu_torch.ops.timing import busy_ms
    from wav2vecsegmenter_tpu_torch.train.loop import train

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        talks, segments = write_corpus(Path(tmp))
        split = {"talk_list": talks, "segments_list": segments,
                 "segment_length": TRAIN_WINDOW}

        def run(mode: str, dtype: str, on_step_extra=None, **extra):
            config = train_config(dev, split, f"{mode}_{dtype}", mode, dtype,
                                  **extra)
            first: list = []

            def on_step(metrics):
                if not first:
                    first.extend(g.detach().float().clone()
                                 for g in metrics["grads"])
                if on_step_extra is not None:
                    on_step_extra()

            before = backend.launch_counts()
            out = train(config, work_dir=tmp, on_step=on_step)
            backend.set_kernels("auto")
            if mode == "eager":
                check(backend.launch_counts() == before,
                      "the eager train run launched kernels")
            check(bool(np.isfinite(out["history"]["loss"]).all()),
                  f"non-finite train loss ({mode}, {dtype})")
            check(out["steps_per_epoch"] == [TRAIN_STEPS] * 2
                  and out["updates"] == 4,
                  f"not two epochs of a full accumulation and a flush: "
                  f"{out['steps_per_epoch']}, {out['updates']} updates")
            return out, first

        backend.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        # checkpoints as a run keeps them: an eval and a checkpoint each
        # epoch's steps and at its end, the newest one kept, and the best
        out_k, grads_k = run("auto", "bfloat16", save_ckpts=True,
                             keep_last_ckpts=1, save_every_steps=TRAIN_STEPS)
        counts = backend.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model = out_k.pop("model")
        book = check_checkpoints(Path(tmp) / "auto_bfloat16", out_k, model)
        st_eval = st_eval_check(dev, model, out_k.pop("generator"),
                                Path(tmp) / "auto_bfloat16" / "ckpts"
                                / "final.pt", Path(tmp))
        fresh, _ = build_model(SHAS_TASK["model"], dev)
        init_from_numpy(fresh, seed=0)
        for key, value in fresh.wav2vec_model.state_dict().items():
            check(torch.equal(value, model.wav2vec_model.state_dict()[key]),
                  f"the frozen backbone moved: {key}")
        head = model.seg_model.state_dict()
        moved = max(float((value - head[key]).abs().max())
                    for key, value in fresh.seg_model.state_dict().items())
        check(moved > 0, "the head did not move")
        del model, fresh, head
        out_e, grads_e = run("eager", "bfloat16")
        out_e.pop("model")
        before_f = backend.launch_counts()
        out_f, grads_f = run("auto", "float32")
        out_f.pop("model")
        counts_f = {k: v - before_f.get(k, 0)
                    for k, v in backend.launch_counts().items()}
        out_fe, grads_fe = run("eager", "float32")
        out_fe.pop("model")
        torch.cuda.empty_cache()
        profiled: dict = {}

        def ready(p):
            profiled["busy_ms"] = busy_ms(p)
            if profile:  # deep enough to list K9's two kernels
                print(p.key_averages().table(sort_by="cuda_time_total",
                                             row_limit=60),
                      file=sys.stderr, flush=True)

        with prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=PROFILED - 1, warmup=1, active=1,
                                     repeat=1),
                   on_trace_ready=ready) as p:
            out_p = run("auto", "bfloat16", on_step_extra=p.step)[0]
        out_p.pop("model")
        torch.cuda.empty_cache()
        steady = reader_steady_state(dev, Path(tmp) / "steady")

    for name in TRAIN_PATH:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the train path")
    # one K10 launch a micro-step (the head's one attention), and K5 15
    # times a forward of the 15-layer backbone (micro-steps and eval)
    micro_steps = len(out_k["history"]["loss"])
    check(counts["attention_bwd"] == micro_steps,
          f"attention_bwd launched {counts['attention_bwd']} times in "
          f"{micro_steps} micro-steps")
    # the float32 arm through the float32 kernels: K4 at least once a
    # micro-step (and at eval), K10 once a micro-step
    f32_steps = len(out_f["history"]["loss"])
    check(counts_f.get("attention_bwd", 0) == f32_steps
          and counts_f.get("attention_bthd", 0) >= f32_steps,
          f"float32 train arm: attention launches {counts_f} in {f32_steps} "
          f"micro-steps")
    check(counts["ffn"] % 15 == 0,
          f"ffn launched {counts['ffn']} times, not 15 a forward")
    # K9 three times a micro-step (the head's norm1, norm2 and final
    # LayerNorm), norm1's without dx: its input is the frozen backbone's
    check(counts["layer_norm_bwd"] == 3 * micro_steps
          and counts["layer_norm_bwd_no_dx"] == micro_steps,
          f"layer_norm_bwd launched {counts['layer_norm_bwd']} times, "
          f"{counts['layer_norm_bwd_no_dx']} without dx, in {micro_steps} "
          f"micro-steps")
    k_vs_f, e_vs_f = grad_dist(grads_k, grads_f), grad_dist(grads_e, grads_f)
    f32_k_vs_e = grad_dist(grads_f, grads_fe)

    def ms(out, key="step_seconds"):
        # median over the micro-steps after the first (the warm-up)
        return float(np.median(out["history"][key][1:]) * 1e3)

    def per_step(out, key):
        return [t * 1e3 for t in out["history"][key]]

    phase("train", reader_backend=native_reads(),
          seconds=time.perf_counter() - t0,
          micro_steps=len(out_k["history"]["loss"]),
          updates=out_k["updates"], loss_kernels=out_k["history"]["loss"],
          loss_eager=out_e["history"]["loss"],
          loss_f32=out_f["history"]["loss"],
          grad_norm_kernels=out_k["history"]["grad_norm"],
          ms_per_micro_step_kernels=ms(out_k),
          ms_per_micro_step_eager=ms(out_e),
          ms_per_micro_step_f32=ms(out_f),
          ms_per_micro_step_f32_eager=ms(out_fe),
          fetch_ms=ms(out_k, "fetch_seconds"),
          read_ms=ms(out_k, "read_seconds"),
          device_busy_ms=profiled["busy_ms"],
          ms_profiled_micro_step=per_step(out_p, "step_seconds")[PROFILED],
          step_ms_kernels=per_step(out_k, "step_seconds"),
          fetch_ms_kernels=per_step(out_k, "fetch_seconds"),
          read_ms_kernels=per_step(out_k, "read_seconds"),
          steady_state=steady,
          eval_kernels=out_k["eval"], eval_eager=out_e["eval"],
          eval_f32=out_f["eval"], checkpoints=book, peak_mem_gb=peak_gb,
          grad_dist_kernels_vs_f32=k_vs_f, grad_dist_eager_vs_f32=e_vs_f,
          grad_dist_f32_kernels_vs_eager=f32_k_vs_e, head_moved=moved,
          layer_norm_bwd_launches=counts["layer_norm_bwd"],
          layer_norm_bwd_no_dx=counts["layer_norm_bwd_no_dx"],
          launches=counts, launches_f32=counts_f)
    check(k_vs_f <= KERNEL_SLACK * e_vs_f,
          f"kernels add error to the head gradients: {k_vs_f} from float32 "
          f"vs {e_vs_f} on the plain path")
    check(f32_k_vs_e <= F32_GRAD,
          f"float32 kernels vs eager head gradients {f32_k_vs_e} > {F32_GRAD}")
    return counts, st_eval


class _Stop(Exception):
    """Ends a train run at a chosen micro-step, as a crash would."""


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def run_resume(dev) -> None:
    """The resume phase: the train phase's bf16 kernels run, twice
    uninterrupted (their spread is the bf16 path's run-to-run spread), then
    once stopped in its second epoch's first micro-step and resumed from
    its run state (``resume=true``): the resumed epoch's losses and
    grad_norms must lie within that spread of the uninterrupted run's."""
    from wav2vecsegmenter_tpu_torch.train.loop import train

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        talks, segments = write_corpus(Path(tmp))
        split = {"talk_list": talks, "segments_list": segments,
                 "segment_length": TRAIN_WINDOW}
        runs = []
        for i in range(2):
            out = train(train_config(dev, split, f"whole{i}", "auto",
                                     "bfloat16"), work_dir=tmp)
            out.pop("model")
            runs.append(out["history"])
        seen = []

        def stop(metrics):
            seen.append(1)
            if len(seen) == TRAIN_STEPS + 1:
                raise _Stop

        config = train_config(dev, split, "cut", "auto", "bfloat16",
                              save_ckpts=True, keep_last_ckpts=1)
        try:
            train(config, work_dir=tmp, on_step=stop)
            check(False, "resume: the first run was not stopped")
        except _Stop:
            pass
        backend.reset_launch_counts()
        out = train(train_config(dev, split, "cut", "auto", "bfloat16",
                                 save_ckpts=True, keep_last_ckpts=1,
                                 resume=True), work_dir=tmp)
        counts = backend.launch_counts()
        out.pop("model")
        torch.cuda.empty_cache()
    spread = {k: max_rel(runs[1][k], runs[0][k])
              for k in ("loss", "grad_norm")}
    got = {k: max_rel(out["history"][k], runs[0][k][TRAIN_STEPS:])
           for k in ("loss", "grad_norm")}
    phase("resume", seconds=time.perf_counter() - t0,
          start_epoch=out["start_epoch"], updates=out["updates"],
          loss_whole=runs[0]["loss"], loss_whole_again=runs[1]["loss"],
          loss_resumed=out["history"]["loss"],
          grad_norm_resumed=out["history"]["grad_norm"],
          run_to_run_spread=spread, resumed_vs_whole=got,
          checkpoints=out["checkpoints"], launches=counts)
    check(out["start_epoch"] == 1 and out["steps_per_epoch"] == [TRAIN_STEPS]
          and out["updates"] == 4,
          f"resume: started at epoch {out['start_epoch']}, "
          f"{out['steps_per_epoch']} micro-steps, {out['updates']} updates")
    for name in TRAIN_PATH:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched in the resumed run")
    for k in got:
        check(got[k] <= spread[k],
              f"resume: {k} {got[k]} from the uninterrupted run, beyond the "
              f"run-to-run spread {spread[k]}")


# The README's LNA recipe (finetune_wav2vec=True): xls-r-300m at 24 layers,
# every layer fine-tuned, no adapters, the FFNs and the feature encoder
# frozen
LNA_TASK = {**SHAS_TASK["model"], "wav2vec_keep_layers": 24,
            "finetune_wav2vec": True, "wav2vec_ft_layers": 24,
            "ffn_adapter": False}
# conf/task/shas.yaml (adapters on, 15 layers) fine-tuning its top 8 layers
# with their FFNs and adapters, and the feature encoder
LNA_DEFAULT_TASK = {**SHAS_TASK["model"], "finetune_wav2vec": True,
                    "wav2vec_ft_layers": 8, "finetune_w2v_feat_enc": True,
                    "finetune_w2v_ffn": True}
# (a) batch 4 on two 100 s talks: 12 windows, three micro-steps an epoch;
# (c) batch 6 on them: two micro-steps
LNA_B, LNA_TALKS, LNA_DEFAULT_B = 4, 2, 6
# the profiled micro-step of an LNA run (0-based: the second of epoch 2, an
# optimizer update, after every shape's first micro-step) and the timed
# ones (the others after the first two)
PROFILED, TIMED_SKIP = 4, (0, 1, 4)


def lna_launches(layers: int, feat_enc: bool) -> dict:
    """A micro-step's launches on an LNA path of ``layers`` encoder layers,
    from the code: K1 on the feature projection's LayerNorm, on two in each
    layer and on three in the head; K9, with dx, on each of those that runs
    under grad (the projection's only with the feature encoder trained; the
    head's first LayerNorm reads a backbone output that needs a gradient);
    K3 and K5 in each layer; K10 in each layer and the head; K4 in the head;
    the seven conv layers (K7's layer 0, K6's 1-6) forward."""
    ln = 1 + 2 * layers + 3
    return {"layer_norm": ln, "layer_norm_bwd": ln - (0 if feat_enc else 1),
            "layer_norm_bwd_no_dx": 0, "attention_packed": layers,
            "attention_bthd": 1, "attention_bwd": layers + 1, "ffn": layers,
            "conv_bias_ln_gelu": 6, "conv_audio_ln_gelu": 1,
            "bias_layer_norm_gelu": 0}


def lna_run(dev, tmp: str, split: dict, model_conf: dict, batch: int,
            epochs: int, mode: str, dtype: str, profile: bool = False,
            save: bool = False, serial: bool = False, tag: str = "") -> dict:
    """One run of the port's loop (``train.loop.train``) on the task
    ``model_conf``, the launch counters reset just before; with ``serial``
    the loaders read serially (``serial_builder``); ``tag`` tells the
    run's directory from another run's of the same arm.  Returns the
    loop's output and: ``grads``, the first micro-step's gradients of every
    trainable parameter (float32 copies); ``steps``, each micro-step's
    launches (not the first of a later epoch, which follows an eval);
    ``peak_gb``, the run's peak device memory; with ``profile``,
    ``profiled``, the device time of micro-step PROFILED + 1 (the union of
    its device intervals, and the 15 ops that launched the most device
    time)."""
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as prof_

    from wav2vecsegmenter_tpu_torch.config import Config, merge
    from wav2vecsegmenter_tpu_torch.ops.timing import busy_ms, top_device_ops
    from wav2vecsegmenter_tpu_torch.train.loop import train

    config = merge(Config(), {
        "exp_name": f"lna_{mode}_{dtype}_{batch}{tag}", "batch_size": batch,
        "learning_rate": 2.5e-4, "max_epochs": epochs, "update_freq": 2,
        "segment_length": TRAIN_WINDOW, "print_every_steps": 100,
        "save_ckpts": save, "keep_last_ckpts": 1, "keep_best_ckpt": False,
        "task": {**SHAS_TASK, "model": model_conf},
        "data": {"train": split, "eval": split},
        "runtime": {"device": dev.type, "compute_dtype": dtype,
                    "kernels": mode, "seed": 0}})
    grads, counts, profiled = [], [], {}

    def ready(p):
        profiled.update(busy_ms=busy_ms(p), top_ops=top_device_ops(p, 15))

    prof = prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=PROFILED - 1, warmup=1, active=1,
                                   repeat=1),
                 on_trace_ready=ready) if profile else None

    def on_step(metrics):
        if not grads:
            grads.extend(g.detach().float().clone() for g in metrics["grads"])
        counts.append(backend.launch_counts())
        if prof is not None:
            prof.step()

    backend.reset_launch_counts()
    zero = backend.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with prof if prof is not None else contextlib.nullcontext(), \
            serial_builder() if serial else contextlib.nullcontext():
        out = train(config, work_dir=tmp, on_step=on_step)
    backend.set_kernels("auto")
    launches = backend.launch_counts()
    if mode == "eager":
        check(backend.launch_counts() == zero,
              "the eager LNA run launched kernels")
    check(bool(np.isfinite(out["history"]["loss"]).all()),
          f"non-finite LNA loss ({mode}, {dtype}, batch {batch})")
    steps, prev, i = [], zero, 0
    for epoch, n in enumerate(out["steps_per_epoch"]):
        for j in range(n):
            if epoch == 0 or j > 0:
                steps.append({k: counts[i][k] - prev[k] for k in counts[i]})
            prev, i = counts[i], i + 1
    return {**out, "grads": grads, "steps": steps, "profiled": profiled,
            "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def step_times(out, skip: tuple = (0, 1)) -> dict:
    """Median wall, fetch (the wait for the batch) and read (its read +
    collate in the reader) ms a micro-step and the fetch's share, over the
    micro-steps not in ``skip`` (the warm-up, a profiled one)."""
    hist = out["history"]
    keep = [i for i in range(len(hist["loss"])) if i not in skip]
    wall = float(np.median([hist["step_seconds"][i] for i in keep]) * 1e3)
    fetch = float(np.median([hist["fetch_seconds"][i] for i in keep]) * 1e3)
    read = float(np.median([hist["read_seconds"][i] for i in keep]) * 1e3)
    return {"ms_per_micro_step": wall, "fetch_ms": fetch, "read_ms": read,
            "fetch_share": fetch / wall, "micro_steps_timed": len(keep)}


def check_functions(dev) -> dict:
    """The autograd Functions whose backward replays a composition in the
    input's type (K5's ``_FFNFn``, K6/K7's ``_ConvLnGeluFn``, K2's
    ``_BiasLnGeluFn``), at the shapes of a 14 x 20 s batch: forward under
    grad through the kernel, then the backward.  Their gradients against
    autograd through the plain version: float32 within F32_GRAD (relative
    L2, each gradient); bf16 as close to the float32 plain gradients as the
    same Function's with the plain forward (eager), within KERNEL_SLACK.
    Times (CUDA events): the Function's forward under grad and backward
    beside the plain version's (K5 also its backward with frozen weights,
    dx only, the LNA recipe's).  Returns each kernel's bf16 row."""
    gd = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.float32, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gd, device=dev) * std
                + mean).to(dtype)

    def ffn_case(dtype):
        return (tffn.ffn, tffn.ffn_plain,
                [randn(B, T, 1024, dtype=dtype), randn(4096, 1024, std=0.03),
                 randn(4096, std=0.1), randn(1024, 4096, std=0.015),
                 randn(1024, std=0.1)], [True] * 5)

    def conv_case(t, c, k, s, dtype):
        return ((lambda *a: conv.conv_bias_ln_gelu(*a, s)),
                (lambda *a: conv.conv_bias_ln_gelu_plain(*a, s)),
                [randn(B, t, c, dtype=dtype),
                 randn(512, c, k, std=(c * k) ** -0.5), randn(512, std=0.3),
                 randn(512, std=0.1, mean=1.0), randn(512, std=0.1)],
                [c > 1] + [True] * 4)  # layer 0's input is the audio

    def bln_case(dtype):
        return (ln.bias_layer_norm_gelu, ln.bias_layer_norm_gelu_plain,
                [randn(B, T_CONV0, 512, std=2.0, mean=0.5, dtype=dtype),
                 randn(512, std=0.3), randn(512, std=0.1, mean=1.0),
                 randn(512, std=0.1)], [True] * 4)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            ("ffn", f"[{B},{T},1024]x4096", dtype,
             lambda d=dtype: ffn_case(d)),
            ("conv_bias_ln_gelu", f"[{B},{T_CONV0},512] k=3 s=2", dtype,
             lambda d=dtype: conv_case(T_CONV0, 512, 3, 2, d)),
            ("conv_audio_ln_gelu", f"[{B},{L_AUDIO}] k=10 s=5", dtype,
             lambda d=dtype: conv_case(L_AUDIO, 1, 10, 5, d)),
            ("bias_layer_norm_gelu", f"[{B},{T_CONV0},512]", dtype,
             lambda d=dtype: bln_case(d))]

    def grads_of(f, inputs, needs, g) -> list:
        out = f(*inputs)
        got = torch.autograd.grad(out, [a for a, n in zip(inputs, needs)
                                        if n], g)
        return [x.float() for x in got]

    def bwd_ms(f, inputs, needs, g) -> float:
        out = f(*inputs)
        want = [a for a, n in zip(inputs, needs) if n]
        return cuda_ms(lambda: torch.autograd.grad(out, want, g,
                                                   retain_graph=True), 3)

    results = {}
    for name, label, dtype, make in cases:
        fn, plain, args, needs = make()
        leaves = [a.requires_grad_(n) for a, n in zip(args, needs)]
        out = fn(*leaves)
        check(out.grad_fn is not None and "Fn" in out.grad_fn.name(),
              f"{name} {label}: the forward under grad took no Function "
              f"({out.grad_fn})")
        g = randn(*out.shape, dtype=dtype)
        del out
        got = grads_of(fn, leaves, needs, g)
        for x in got:
            check(bool(torch.isfinite(x).all()), f"{name} {label}: non-finite")
        backend.set_kernels("eager")
        got_e = grads_of(fn, leaves, needs, g)
        backend.set_kernels("auto")
        if dtype == torch.bfloat16:  # the float32 oracle on the same values
            ref = grads_of(plain, [a.detach().float().requires_grad_(n)
                                   for a, n in zip(leaves, needs)], needs,
                           g.float())
        else:
            ref = grads_of(plain, leaves, needs, g)
        dists = [grad_dist([x], [r]) for x, r in zip(got, ref)]
        dists_e = [grad_dist([x], [r]) for x, r in zip(got_e, ref)]
        limit = F32_GRAD if dtype == torch.float32 else KERNEL_SLACK
        ok = all(d <= (limit if dtype == torch.float32 else limit * de)
                 for d, de in zip(dists, dists_e))
        del got, got_e, ref
        row = {"fwd_ms": cuda_ms(lambda: fn(*leaves), 3),
               "bwd_ms": bwd_ms(fn, leaves, needs, g),
               "plain_fwd_ms": cuda_ms(lambda: plain(*leaves), 3),
               "plain_bwd_ms": bwd_ms(plain, leaves, needs, g),
               "grad_dist": dists, "grad_dist_eager": dists_e}
        if name == "ffn":  # the LNA recipe's: frozen weights, dx only
            dx_only = [True] + [False] * 4
            frozen = [leaves[0]] + [a.detach() for a in leaves[1:]]
            row["bwd_ms_dx_only"] = bwd_ms(fn, frozen, dx_only, g)
            row["plain_bwd_ms_dx_only"] = bwd_ms(plain, frozen, dx_only, g)
        dname = str(dtype).replace("torch.", "")
        phase("function", name=name, shape=label, dtype=dname,
              inputs_with_grad=sum(needs), **row)
        check(ok, f"{name} {label} {dname}: gradient distances {dists} "
                  f"(eager {dists_e}) beyond {limit}")
        del leaves, args, g
        torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            results[name] = row
    return results


def time_pos_conv(dev) -> list:
    """The positional conv (cuDNN, grouped, k=128) under LNA, bf16 at the
    LNA batches 4 and 14 and both audio buckets: forward and backward
    (CUDA events) and the device ms of the backward's data-gradient and
    weight-gradient kernels, with cuDNN's heuristics and in its benchmark
    mode (autotuned).  A reference point for the LNA micro-step's
    breakdown, not a kernel of the port."""
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import (
        PositionalConvEmbedding, Wav2Vec2Config, positional_conv)

    cfg = Wav2Vec2Config()
    pe = PositionalConvEmbedding(cfg, dev)
    init_from_numpy(pe, seed=0)
    gd = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for benchmark in (False, True):
        torch.backends.cudnn.benchmark = benchmark
        for b in (LNA_B, B):
            for t in (T, T_TAIL):
                x = torch.randn(b, t, 1024, generator=gd, device=dev
                                ).bfloat16().requires_grad_()
                g = torch.randn(b, t, 1024, generator=gd, device=dev
                                ).bfloat16()
                y = positional_conv(pe, x, cfg, torch.bfloat16)
                leaves = [x, *pe.parameters()]

                def bwd():
                    return torch.autograd.grad(y, leaves, g,
                                               retain_graph=True)

                rows.append({
                    "cudnn_benchmark": benchmark, "shape": [b, t, 1024],
                    "fwd_ms": cuda_ms(lambda: positional_conv(
                        pe, x, cfg, torch.bfloat16), 5),
                    "bwd_ms": cuda_ms(bwd, 5),
                    "bwd_device_ms": device_ms(bwd, 3, ("dgrad", "wgrad"))})
    torch.backends.cudnn.benchmark = False
    phase("pos_conv", rows=rows)
    return rows


def run_lna(dev) -> dict:
    """The lna phase ((a)-(e) of the module docstring); returns the
    launches of the recipe's bf16 kernels run and the Function rows."""
    from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
        load_reference_checkpoint)
    from wav2vecsegmenter_tpu_torch.cli.common import build_model

    t0 = time.perf_counter()
    functions = check_functions(dev)
    time_pos_conv(dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "two").mkdir()
        (root / "six").mkdir()
        split = dict(zip(("talk_list", "segments_list"),
                         write_corpus(root / "two", LNA_TALKS)),
                     segment_length=TRAIN_WINDOW)
        split14 = dict(zip(("talk_list", "segments_list"),
                           write_corpus(root / "six")),
                       segment_length=TRAIN_WINDOW)

        # (a) the recipe, four runs from the same weights and seed
        runs = {}
        for mode, dtype in (("auto", "bfloat16"), ("eager", "bfloat16"),
                            ("auto", "float32"), ("eager", "float32")):
            runs[mode, dtype] = lna_run(
                dev, tmp, split, LNA_TASK, LNA_B, 2, mode, dtype,
                profile=(mode, dtype) == ("auto", "bfloat16"),
                save=(mode, dtype) == ("auto", "bfloat16"))
            check(runs[mode, dtype]["steps_per_epoch"] == [3, 3]
                  and runs[mode, dtype]["updates"] == 4,
                  f"LNA: not two epochs of a full accumulation and a "
                  f"flush: {runs[mode, dtype]['steps_per_epoch']}")
        k = runs["auto", "bfloat16"]
        want = lna_launches(24, feat_enc=False)
        for i, got in enumerate(k["steps"]):
            check({n: got[n] for n in want} == want,
                  f"LNA micro-step {i} launches {got}, not {want}")
        # the float32 arm through the float32 attention kernels (K3, K4,
        # K10) as many times a micro-step
        attn_want = {n: want[n] for n in ("attention_packed",
                                          "attention_bthd", "attention_bwd")}
        for i, got in enumerate(runs["auto", "float32"]["steps"]):
            check({n: got[n] for n in attn_want} == attn_want,
                  f"LNA float32 micro-step {i} attention launches {got}, "
                  f"not {attn_want}")
        model = k.pop("model")
        fresh, _ = build_model(LNA_TASK, dev)
        init_from_numpy(fresh, seed=0)
        trained = {n for n, p in model.named_parameters() if p.requires_grad}
        moved = moved_check(model, fresh, trained, "LNA")
        groups = ("layer_norm", "final_layer_norm", "q_proj", "k_proj",
                  "v_proj", "out_proj", "pos_conv_embed", "seg_model")
        check(all(any(f".{g}." in "." + n + "." for n in trained)
                  for g in groups), f"LNA: a trained group is missing")
        check(not any(".feed_forward." in n or ".feature_" in n
                      for n in trained), "LNA: the FFNs or the feature "
                                         "encoder were trained")
        k_vs_f = grad_dist(k["grads"], runs["auto", "float32"]["grads"])
        e_vs_f = grad_dist(runs["eager", "bfloat16"]["grads"],
                           runs["auto", "float32"]["grads"])
        f32_k_vs_e = grad_dist(runs["auto", "float32"]["grads"],
                               runs["eager", "float32"]["grads"])
        for r in runs.values():
            r.pop("model", None)
            del r["grads"]

        # (e) the recipe's final checkpoint: full layout, loaded back
        # strictly, segments one talk
        path = k["checkpoint"]
        saved = torch.load(path, map_location="cpu", weights_only=True)
        check(set(saved["state_dict"]) == set(model.state_dict()),
              "LNA checkpoint: not the full state_dict")
        del saved
        back, _ = build_model(LNA_TASK, dev)
        load_reference_checkpoint(path, back)
        for (name, p), (_, q) in zip(model.state_dict().items(),
                                     back.state_dict().items()):
            check(torch.equal(p, q), f"LNA checkpoint: {name} differs")
        del model, fresh
        torch.cuda.empty_cache()
        back.eval()
        talk = root / "talk.wav"
        write_talk(talk, 65.0, seed=3)
        probs: dict = {}
        rows = segment_wavs(back, [talk], PTHR, B, 20.0, 1, dev,
                            torch.bfloat16, talk_probs=probs)
        p = probs[talk.name]
        check(bool(rows) and p.shape == (round(65.0 * 49.95),)
              and bool(np.isfinite(p).all()),
              "LNA checkpoint: the talk did not segment")
        del back
        torch.cuda.empty_cache()

        # (f) the reader's cost at the recipe's batch: one epoch over the
        # train phase's corpus, the reader, the serial builder twice, the
        # reader (walls drift from run to run within a call; this order
        # cancels a steady drift)
        arms: dict = {"reader": [], "serial": []}
        for i, arm in enumerate(("reader", "serial", "serial", "reader")):
            r = lna_run(dev, tmp, split14, LNA_TASK, LNA_B, 1, "auto",
                        "bfloat16", serial=arm == "serial", tag=f"_{arm}{i}")
            r.pop("model")
            for j, got in enumerate(r["steps"]):
                check({n: got[n] for n in want} == want,
                      f"LNA {arm} micro-step {j} launches {got}")
            arms[arm].append({k: [t * 1e3 for t in r["history"][k]]
                              for k in ("step_seconds", "read_seconds")})
            del r
            torch.cuda.empty_cache()

        def arm_line(runs):
            # medians over both runs' micro-steps after the first two, and
            # over the last two (the reader has read the epoch by then)
            steps = [x for r in runs for x in r["step_seconds"][2:]]
            done = [x for r in runs for x in r["step_seconds"][-2:]]
            reads = [x for r in runs for x in r["read_seconds"][2:]]
            return {"ms_per_micro_step": float(np.median(steps)),
                    "ms_per_micro_step_last_two": float(np.median(done)),
                    "read_ms": float(np.median(reads)),
                    "ms_per_micro_step_runs": [
                        float(np.median(r["step_seconds"][2:]))
                        for r in runs],
                    "step_ms": [r["step_seconds"] for r in runs]}

        reader_cost = {arm: arm_line(runs) for arm, runs in arms.items()}

        # (b) the reference batch: 14 x 20 s windows, bf16 kernels
        k14 = lna_run(dev, tmp, split14, LNA_TASK, B, 2, "auto", "bfloat16",
                      profile=True)
        k14.pop("model")
        for i, got in enumerate(k14["steps"]):
            check({n: got[n] for n in want} == want,
                  f"LNA batch {B} micro-step {i} launches {got}")

        # (c) the default task's adapters, FFNs and feature encoder
        c = lna_run(dev, tmp, split, LNA_DEFAULT_TASK, LNA_DEFAULT_B, 1,
                    "auto", "bfloat16")
        check(c["steps_per_epoch"] == [2] and c["updates"] == 1,
              f"LNA default task: {c['steps_per_epoch']} micro-steps")
        want_c = lna_launches(15, feat_enc=True)
        for i, got in enumerate(c["steps"]):
            check({n: got[n] for n in want_c} == want_c,
                  f"LNA default task micro-step {i} launches {got}, not "
                  f"{want_c}")
        model = c.pop("model")
        fresh, _ = build_model(LNA_DEFAULT_TASK, dev)
        init_from_numpy(fresh, seed=0)
        adapters = set()
        for (name, p), (_, p0) in zip(model.named_parameters(),
                                      fresh.named_parameters()):
            layer = (int(name.split(".")[4]) if ".encoder.layers." in name
                     else None)
            if ".ffn_adapter." in name:
                adapters.add(layer)
            if layer is not None and layer < 7:
                check(torch.equal(p, p0), f"LNA default task: {name} moved")
            elif (".ffn_adapter." in name or ".feature_extractor." in name):
                check(not torch.equal(p, p0),
                      f"LNA default task: {name} did not move")
        check(adapters == set(range(7, 15)),
              f"LNA default task: adapters in layers {sorted(adapters)}")
        del model, fresh
        torch.cuda.empty_cache()

    phase("lna", reader_backend=native_reads(),
          seconds=time.perf_counter() - t0,
          micro_steps=len(k["history"]["loss"]), updates=k["updates"],
          loss_kernels=k["history"]["loss"],
          loss_eager=runs["eager", "bfloat16"]["history"]["loss"],
          loss_f32=runs["auto", "float32"]["history"]["loss"],
          grad_norm_kernels=k["history"]["grad_norm"],
          eval_kernels=k["eval"],
          grad_dist_kernels_vs_f32=k_vs_f, grad_dist_eager_vs_f32=e_vs_f,
          grad_dist_f32_kernels_vs_eager=f32_k_vs_e,
          params_frozen=moved["frozen"], params_trained=moved["trained"],
          launches_per_micro_step=want,
          launches_per_micro_step_default_task=want_c,
          batch4={**step_times(k, TIMED_SKIP), "peak_mem_gb": k["peak_gb"],
                  "device_busy_ms": k["profiled"]["busy_ms"],
                  "ms_per_micro_step_eager": step_times(
                      runs["eager", "bfloat16"])["ms_per_micro_step"],
                  "ms_per_micro_step_f32": step_times(
                      runs["auto", "float32"])["ms_per_micro_step"],
                  "step_ms": [t * 1e3 for t in k["history"]["step_seconds"]],
                  "read_ms_steps": [t * 1e3 for t in
                                    k["history"]["read_seconds"]],
                  "top_ops": k["profiled"]["top_ops"]},
          batch4_reader_cost=reader_cost,
          batch14={**step_times(k14, TIMED_SKIP),
                   "peak_mem_gb": k14["peak_gb"],
                   "device_busy_ms": k14["profiled"]["busy_ms"],
                   "step_ms": [t * 1e3 for t in
                               k14["history"]["step_seconds"]],
                   "top_ops": k14["profiled"]["top_ops"]},
          default_task={"loss": c["history"]["loss"],
                        "peak_mem_gb": c["peak_gb"]},
          segments=len(rows))
    check(k_vs_f <= KERNEL_SLACK * e_vs_f,
          f"LNA: kernels add error to the gradients: {k_vs_f} from float32 "
          f"vs {e_vs_f} on the plain path")
    check(f32_k_vs_e <= F32_GRAD,
          f"LNA: float32 kernels vs eager gradients {f32_k_vs_e} > "
          f"{F32_GRAD}")
    return {"launches": k["launches"], "functions": functions}



# conf/task/shas_ssl.yaml: the untruncated lv60-self CTC model (24 layers
# and its final encoder LayerNorm, lm_head 1024 -> 32) and a 36-way SFC head
# on the char vocabulary, the backbone frozen, pseudo-labels from the CTC
# head; conf/task/shas_ctc.yaml: xls-r-300m cut to 15 layers, fine-tuned on
# transcripts with the CTC loss
SSL_TASK = {
    "autoregression": False,
    "model": {"_target_": "lib.models.SHASWithSSL",
              "wav2vec_model_name": "facebook/wav2vec2-large-960h-lv60-self",
              "finetune_wav2vec": False, "n_transformer_enc_layers": 1,
              "n_transformer_enc_heads": 8, "init_dropout": 0.1},
    "train_generator": {"_target_": "lib.dataset.RandomDataloaderGenerator"},
    "eval_generator": {"inference_times": 1},
    "vocab": {"_target_": "lib.datautils.UppercasedCharVocabulary"},
    "loss": {"_target_": "torch.nn.CrossEntropyLoss", "tag": "ssl",
             "reduction": "none"},
}
CTC_TASK = {
    **SSL_TASK,
    "model": {"_target_": "lib.models.SHASWithCTC",
              "wav2vec_model_name": "facebook/wav2vec2-xls-r-300m",
              "wav2vec_keep_layers": 15, "finetune_wav2vec": True,
              "n_transformer_enc_layers": 1, "n_transformer_enc_heads": 8,
              "init_dropout": 0.1},
    "loss": {"_target_": "torch.nn.CTCLoss", "tag": "ctc",
             "reduction": "mean"},
}
DAC_LOGITS = {"tag": "dac_logits", "max_segment_length": 18,
              "min_segment_length": 0.2}
DAC = {"tag": "dac", "max_segment_length": 16, "min_segment_length": 0.2,
       "threshold": 0.5}
# the random 36-way head's output layer: weights x4 (logits of std ~2.3);
# then <B>'s bias is raised by the median gap to the other 35 logits'
# maximum on the full batch (float32), so that p(<B>) is about a half on
# the median frame and the argmax is <B> on about half the frames (the
# random backbone's frames lie close together, so a fixed bias misses),
# as the slice's x40 spreads its sigmoid
SSL_OUT_SCALE = 4.0
# ssl: batch 14 on the train phase's six 100 s talks (three micro-steps);
# ctc: batch 4 on two of them with transcripts (three micro-steps)
CTC_B, CTC_TALKS = 4, 2


def ssl_outputs(model, batch, dev, dtype, mode: str):
    """One batch through SHASWithSSL as the engine uploads and normalizes
    it: p(<B>) on out_mask, the CTC logits and the frame logits (float32),
    as numpy."""
    from wav2vecsegmenter_tpu_torch.infer.pipeline import (normalize_int16,
                                                           upload)

    backend.set_kernels(mode)
    with torch.inference_mode():
        out_mask = upload(batch.out_mask, dev)
        audio = normalize_int16(upload(batch.audio, dev), batch.norm_length,
                                upload(batch.included, dev))
        ctc, frame = model(audio, upload(batch.in_lengths, dev), out_mask,
                           dtype)
        probs = torch.where(out_mask, torch.softmax(frame.float(), -1)[..., 0],
                            0.0)
        out = (probs.cpu().numpy(), ctc.float().cpu().numpy(),
               frame.float().cpu().numpy())
    backend.set_kernels("auto")
    return out


def ssl_train_run(dev, tmp: str, split: dict, task: dict, batch: int,
                  mode: str, dtype: str) -> dict:
    """One epoch of the port's loop on ``task`` (update_freq 1, seed 0, no
    checkpoints), the launch counters reset just before: the loop's output
    with ``grads`` (the first micro-step's, float32 copies), ``launches``
    and ``peak_gb``."""
    from wav2vecsegmenter_tpu_torch.config import Config, merge
    from wav2vecsegmenter_tpu_torch.train.loop import train

    config = merge(Config(), {
        "exp_name": f"{task['loss']['tag']}_{mode}_{dtype}",
        "batch_size": batch, "learning_rate": 2.5e-4, "max_epochs": 1,
        "update_freq": 1, "segment_length": TRAIN_WINDOW,
        "print_every_steps": 100, "save_ckpts": False, "task": task,
        "data": {"train": split, "eval": split},
        "runtime": {"device": dev.type, "compute_dtype": dtype,
                    "kernels": mode, "seed": 0}})
    grads = []

    def on_step(metrics):
        if not grads:
            grads.extend(g.detach().float().clone() for g in metrics["grads"])

    backend.reset_launch_counts()
    zero = backend.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = train(config, work_dir=tmp, on_step=on_step)
    backend.set_kernels("auto")
    launches = backend.launch_counts()
    if mode == "eager":
        check(launches == zero, f"the eager {config.exp_name} run launched "
                                f"kernels")
    check(bool(np.isfinite(out["history"]["loss"]).all()),
          f"non-finite loss in {config.exp_name}")
    out.pop("model")
    return {**out, "grads": grads, "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def run_ssl(dev) -> dict:
    """The ssl phase: SHASWithSSL at the lv60-self width (24 layers) loaded
    from a full-layout checkpoint of seeded random weights through the
    inference CLIs' loader (``cli.common.load_model``); the segment path
    with dac_logits and dac, kernels and eager; one full batch's fidelity
    against the float32 plain path and its times; then three micro-steps
    of task=shas_ssl (frozen backbone, batch 14) and of task=shas_ctc
    (fine-tuned, batch 4) in three arms each.  Returns the launch counts
    of the dac_logits segment run with the kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_

    from wav2vecsegmenter_tpu_torch.cli.common import build_model, load_model
    from wav2vecsegmenter_tpu_torch.config import Config
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu_torch.models.shas import SHASWithSSL
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import frame_lengths
    from wav2vecsegmenter_tpu_torch.ops.timing import top_device_ops

    t_phase = time.perf_counter()
    batch = full_batch()
    with tempfile.TemporaryDirectory() as tmp:
        # the checkpoint: seeded numpy weights in the reference's SSL full
        # layout (wav2vec_model.model.wav2vec2.*, .lm_head.*, seg_model.*)
        made, _ = build_model(SSL_TASK, dev)
        init_from_numpy(made, seed=0)
        out = made.seg_model.output_layer
        with torch.no_grad():
            out.weight.mul_(SSL_OUT_SCALE)
            frame = ssl_outputs(made.eval(), batch, dev, torch.float32,
                                "eager")[2][batch.out_mask]
            b_bias = float(np.median(frame[:, 1:].max(-1) - frame[:, 0]))
            out.bias[0] += b_bias
        ckpt = Path(tmp) / "ssl.pt"
        torch.save({"state_dict": made.state_dict()}, ckpt)
        del made
        model, vocab, _, _ = load_model(Config({
            "task": SSL_TASK, "runtime": {"device": dev.type,
                                          "kernels": "auto"}}), ckpt)
    cfg = model.w2v_cfg
    check(isinstance(model, SHASWithSSL) and cfg.num_layers == 24
          and cfg.hidden_size == 1024 and cfg.num_heads == 16
          and cfg.ffn_dim == 4096 and vocab.vocab_size == 36
          and model.seg_model.output_layer.out_features == 36
          and model.wav2vec_model.model.lm_head.out_features == 32,
          "ssl: not SHASWithSSL at the lv60-self width")
    n_params = sum(p.numel() for p in model.parameters())

    # the segment path: dac_logits and dac, kernels and eager
    expected = batch_launches(model)
    expected["layer_norm"] += 1  # the final encoder LayerNorm
    with tempfile.TemporaryDirectory() as tmp:
        secs = {"talk1.wav": 65.0, "talk2.wav": 41.0}
        wavs = [Path(tmp) / name for name in secs]
        for seed, w in enumerate(wavs):
            write_talk(w, secs[w.name], seed)

        def run(algo: dict, mode: str):
            backend.set_kernels(mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = segment_wavs(model, wavs, algo, B, 20.0, 1, dev,
                                torch.bfloat16, loss_tag="ssl", vocab=vocab)
            torch.cuda.synchronize()
            backend.set_kernels("auto")
            return rows, (time.perf_counter() - t0) * 1e3

        run(DAC_LOGITS, "auto")  # warm-up
        run(DAC_LOGITS, "eager")
        backend.reset_launch_counts()
        rows = {("dac_logits", "auto"): run(DAC_LOGITS, "auto")}
        counts = backend.launch_counts()
        before = backend.launch_counts()
        for algo in (DAC_LOGITS, DAC):
            rows[algo["tag"], "eager"] = run(algo, "eager")
        check(backend.launch_counts() == before,
              "the eager ssl runs launched kernels")
        rows["dac", "auto"] = run(DAC, "auto")
        walls = {"dac_logits": [rows["dac_logits", "auto"][1]],
                 "dac": [rows["dac", "auto"][1]]}
        for tag in ("dac", "dac_logits", "dac_logits", "dac"):
            walls[tag].append(run(DAC_LOGITS if tag == "dac_logits"
                                  else DAC, "auto")[1])
    for name, n in expected.items():
        check(counts.get(name, 0) == n * SLICE_BATCHES,
              f"ssl segment path: {name} launched {counts.get(name, 0)} "
              f"times, not {n} a batch")

    def marks(rs):
        return [(r["offset"], r["duration"]) for r in rs]

    segs = {f"{t}_{m}": len(r[0]) for (t, m), r in rows.items()}
    for (t, m), r in rows.items():
        check({x["wav"] for x in r[0]} == set(secs), f"ssl {t} {m}: a talk "
                                                     f"got no segments")
    diff = {t: boundary_diff(marks(rows[t, "auto"][0]),
                             marks(rows[t, "eager"][0]))
            for t in ("dac_logits", "dac")}

    # fidelity: one full batch, bf16 kernels and bf16 plain against the
    # float32 plain path
    arms = {"kernels": ssl_outputs(model, batch, dev, torch.bfloat16, "auto"),
            "eager": ssl_outputs(model, batch, dev, torch.bfloat16, "eager"),
            "f32": ssl_outputs(model, batch, dev, torch.float32, "eager")}
    mask = batch.out_mask
    fl = frame_lengths(torch.from_numpy(batch.in_lengths), cfg).numpy()
    valid = np.arange(arms["f32"][1].shape[1])[None, :] < fl[:, None]
    fid = {}
    fp, fc, ff = arms["f32"]
    for arm in ("kernels", "eager"):
        p, c, f = arms[arm]
        check(bool(np.isfinite(p).all() and np.isfinite(c).all()),
              f"ssl {arm}: non-finite outputs")
        fid[arm] = {
            "dprob": dprob_stats(np.abs(p - fp)[mask]),
            "dctc": dprob_stats(np.abs(c - fc)[valid]),
            "frame_argmax_agree": float(
                (f.argmax(-1) == ff.argmax(-1))[mask].mean()),
            "ctc_argmax_agree": float(
                (c.argmax(-1) == fc.argmax(-1))[valid].mean())}
    for key in ("dprob", "dctc"):
        for q in ("mean", "p99"):
            k, e = fid["kernels"][key][q], fid["eager"][key][q]
            check(k <= KERNEL_SLACK * e, f"ssl kernels add error: {key} {q} "
                                         f"{k} vs {e} on the plain path")
    spread = {"b_bias": b_bias,
              "p_b_f32_percentiles_1_50_99": [
                  float(x) for x in np.percentile(fp[mask], [1, 50, 99])],
              "argmax_b_share_f32": float(
                  (ff.argmax(-1) == vocab.boundary_token_id)[mask].mean())}
    del arms

    # times: the batch through the engine, kernels and eager in turns
    engine = WindowInference(model, dev, torch.bfloat16, loss_tag="ssl")

    def once(mode):
        backend.set_kernels(mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_batch(batch).numpy()
        ms = (time.perf_counter() - t0) * 1e3
        backend.set_kernels("auto")
        return ms

    ms = {"auto": [], "eager": []}
    once("auto")
    once("eager")
    torch.cuda.reset_peak_memory_stats()
    for mode in ("auto", "eager", "eager", "auto", "auto", "eager"):
        ms[mode].append(once(mode))
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy = device_busy_ms(lambda: engine.run_batch(batch).numpy(), 3)
    with prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        engine.run_batch(batch).numpy()
    top_ops = top_device_ops(p, 12)
    backend.reset_launch_counts()
    engine.run_batch(batch).numpy()
    per_batch = backend.launch_counts()
    check(all(per_batch.get(k, 0) == n for k, n in expected.items()),
          f"ssl batch launches {per_batch}, not {expected}")
    phase("ssl", params=n_params, layers=cfg.num_layers,
          segments=segs, boundaries_kernels_vs_eager=diff,
          ms_segment_kernels=walls,
          fidelity=fid, head=spread,
          batch_ms_kernels=ms["auto"], batch_ms_eager=ms["eager"],
          batch_device_busy_ms=busy, batch_top_device_ops=top_ops,
          audio_per_wall_kernels=B * 20.0 / (np.median(ms["auto"]) / 1e3),
          peak_mem_gb=peak, launches_segment=counts,
          launches_batch=per_batch)
    del engine, model
    torch.cuda.empty_cache()

    # training: task=shas_ssl (frozen backbone) and task=shas_ctc
    # (fine-tuned on transcripts), bf16 kernels / bf16 eager / float32 eager
    train_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ssl_dir, ctc_dir = Path(tmp) / "ssl", Path(tmp) / "ctc"
        ssl_dir.mkdir()
        ctc_dir.mkdir()
        talks, segments = write_corpus(ssl_dir)
        ssl_split = {"talk_list": talks, "segments_list": segments,
                     "segment_length": TRAIN_WINDOW}
        talks, segments = write_corpus(ctc_dir, CTC_TALKS, texts=True)
        ctc_split = {"talk_list": talks, "segments_list": segments,
                     "segment_length": TRAIN_WINDOW}
        for tag, task, split, b in (("ssl", SSL_TASK, ssl_split, B),
                                    ("ctc", CTC_TASK, ctc_split, CTC_B)):
            runs = {arm: ssl_train_run(dev, tmp, split, task, b, mode, dt)
                    for arm, mode, dt in (("kernels", "auto", "bfloat16"),
                                          ("eager", "eager", "bfloat16"),
                                          ("f32", "eager", "float32"))}
            k = runs["kernels"]
            want = ("layer_norm", "attention_packed", "attention_bthd", "ffn",
                    "conv_bias_ln_gelu", "conv_audio_ln_gelu",
                    "attention_bwd")
            check(all(k["launches"].get(n, 0) > 0 for n in want)
                  and k["launches"].get("layer_norm_bwd", 0)
                  + k["launches"].get("layer_norm_bwd_no_dx", 0) > 0,
                  f"{tag} training: a kernel of the path never launched: "
                  f"{k['launches']}")
            k_vs_f = grad_dist(k["grads"], runs["f32"]["grads"])
            e_vs_f = grad_dist(runs["eager"]["grads"], runs["f32"]["grads"])
            check(k_vs_f <= KERNEL_SLACK * e_vs_f,
                  f"{tag} training: kernels' first gradients {k_vs_f} from "
                  f"float32, the plain path's {e_vs_f}")
            train_out[tag] = {
                "batch": b, "micro_steps": k["steps_per_epoch"],
                "loss": {a: r["history"]["loss"] for a, r in runs.items()},
                "grad_dist_kernels_vs_f32": k_vs_f,
                "grad_dist_eager_vs_f32": e_vs_f,
                "ms_per_micro_step": {
                    a: float(np.median(r["history"]["step_seconds"][1:]) * 1e3)
                    for a, r in runs.items()},
                "peak_gb": {a: r["peak_gb"] for a, r in runs.items()},
                "eval": k["eval"], "launches": k["launches"]}
            del runs
            torch.cuda.empty_cache()
    phase("ssl_train", **train_out, seconds=time.perf_counter() - t_phase)
    return counts


# conf/task/arseg.yaml: xls-r-300m cut to 15 layers, frozen, a 1-layer
# encoder and a 4-layer decoder of 8 heads over the 4-token vocabulary
ARSEG_TASK = {
    "autoregression": True,
    "model": {"_target_": "lib.models.AutoRegSegmenter",
              "wav2vec_model_name": "facebook/wav2vec2-xls-r-300m",
              "wav2vec_keep_layers": 15, "finetune_wav2vec": False,
              "n_transformer_enc_layers": 1, "n_transformer_enc_heads": 8,
              "n_transformer_dec_layers": 4, "n_transformer_dec_heads": 8,
              "init_dropout": 0.1},
    "train_generator": {"_target_": "lib.dataset.RandomDataloaderGenerator"},
    "eval_generator": {"inference_times": 1},
    "vocab": {"_target_": "lib.datautils.BaseVocabulary"},
    "loss": {"_target_": "torch.nn.CrossEntropyLoss", "tag": "ce",
             "reduction": "none"},
}
# the random decoder's output layer: the <B> and <NB> rows x4, then <NB>'s
# bias moved to the midpoint of the two plateaus its float32 decode of the
# full batch settles on.  The random decoder has no positional signal and
# feeds its tokens back: a window's gap settles after a few frames on a
# value set by the token it keeps choosing (the first decode's median
# gap), and shifting the bias by that median flips the choice and shows
# the other plateau (the second decode's median); half-way between them
# each window keeps the token its first frames choose
ARSEG_OUT_SCALE = 4.0
# K1 launches a batch: the encode's (the backbone's 31, the encoder
# layer's 2 and the shared LayerNorm) and 13 a decode step (3 in each of
# the 4 decoder layers and the shared LayerNorm)
ARSEG_LN_ENCODE, ARSEG_LN_STEP = 34, 13


def arseg_inputs(batch, dev):
    """The engine's inputs of an offline batch: the audio normalized on the
    device, the lengths, out_mask."""
    from wav2vecsegmenter_tpu_torch.infer.pipeline import (normalize_int16,
                                                           upload)

    return (normalize_int16(upload(batch.audio, dev), batch.norm_length,
                            upload(batch.included, dev)),
            upload(batch.in_lengths, dev), upload(batch.out_mask, dev))


def arseg_decode(model, batch, dev, dtype, mode: str):
    """One batch's greedy decode at ``dtype`` under kernel mode ``mode``:
    (probs, logits, tokens) as numpy, and the wall ms."""
    backend.set_kernels(mode)
    audio, lengths, out_mask = arseg_inputs(batch, dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.greedy_decode(audio, lengths, out_mask.shape[1], dtype)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    backend.set_kernels("auto")
    return tuple(x.float().cpu().numpy() for x in out), ms


def arseg_forced(model, batch, dev, dtype, mode: str, tokens: np.ndarray):
    """The teacher-forced logits at ``dtype`` under ``mode``, fed the SEP-led
    ``tokens`` (every key valid), as numpy float32."""
    backend.set_kernels(mode)
    audio, lengths, _ = arseg_inputs(batch, dev)
    tok = torch.from_numpy(tokens).long().to(dev)
    sep = torch.full_like(tok[:, :1], 3)  # <SEP>, the decode's first input
    target_in = torch.cat([sep, tok[:, :-1]], 1)
    with torch.inference_mode():
        logits = model(audio, lengths, target_in,
                       torch.ones_like(target_in, dtype=torch.bool), dtype)
    backend.set_kernels("auto")
    return logits.float().cpu().numpy()


def arseg_train(dev, model, sd: dict, batches: list, mode: str,
                dtype) -> dict:
    """Three micro-steps of ``train.step.make_train_step`` with
    ``autoregression`` from the weights ``sd`` (frozen backbone, update
    each micro-step, dropout from a generator seeded 0), the launch
    counters reset just before each: losses, the first micro-step's
    gradients, each micro-step's launches and wall ms, the backbone
    unchanged and the head moved, peak memory."""
    from wav2vecsegmenter_tpu_torch.data.vocab import BaseVocabulary
    from wav2vecsegmenter_tpu_torch.train.loss import build_loss
    from wav2vecsegmenter_tpu_torch.train.step import (AccumulatingAdamW,
                                                       make_train_step)

    model.load_state_dict(sd)
    model.train()
    params = model.set_requires_grad()
    vocab = BaseVocabulary()
    loss_fn, _, _ = build_loss(ARSEG_TASK["loss"], None, vocab)
    opt = AccumulatingAdamW(params, 2.5e-4, 10, 1)
    step = make_train_step(model, loss_fn, 0, opt, dtype,
                           torch.Generator(device=dev).manual_seed(0), "ce",
                           vocab, autoregression=True)
    backend.set_kernels(mode)
    out = {"loss": [], "ms": [], "launches": []}
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        backend.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch)
        out["loss"].append(float(m["loss"]))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(backend.launch_counts())
        if "grads" not in out:
            out["grads"] = [gr.detach().float().clone() for gr in m["grads"]]
        del m
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _, busy, wall = profiled(lambda: step(batches[0]))
    out.update(device_busy_ms=busy, profiled_wall_ms=wall)
    backend.set_kernels("auto")
    after = model.state_dict()
    out["backbone_unchanged"] = all(
        torch.equal(after[k], v) for k, v in sd.items()
        if not k.startswith("seg_model."))
    out["head_moved"] = all(not torch.equal(after[k], v)
                            for k, v in sd.items()
                            if k.startswith("seg_model."))
    check(bool(np.isfinite(out["loss"]).all()),
          f"arseg training {mode} {dtype}: non-finite loss {out['loss']}")
    return out


def run_arseg(dev) -> dict:
    """The arseg phase: the autoregressive segmenter at the xls-r-300m width
    (15 layers, a 1-layer encoder and a 4-layer decoder of 8 heads, V=4;
    seeded random weights, the output layer calibrated) saved as the
    port's full-layout ``.pt`` and loaded through the inference CLIs'
    loader (``cli.common.load_model``, task=arseg); the slice's two talks
    through ``cli.common.segment_wavs`` at batch 14 with pTHR (bf16
    kernels, the launch counters reset just before; bf16 eager, counters
    unmoved; float32): segments, token agreement with float32, walls;
    one full batch's decode in the three arms (launches a batch, wall and
    device-busy ms, host ms a decode step, peak memory), the teacher-forced
    forward fed the float32 decode's tokens (the kernels' bf16 logits as
    close to float32 as the eager path's, within KERNEL_SLACK); then three
    micro-steps of ``make_train_step`` (frozen backbone, batch 14) in
    three arms.  Returns the launch counts of the kernels' segment run."""
    from wav2vecsegmenter_tpu_torch.cli.common import build_model, load_model
    from wav2vecsegmenter_tpu_torch.config import Config
    from wav2vecsegmenter_tpu_torch.data.loader import (
        RandomDataloaderGenerator)
    from wav2vecsegmenter_tpu_torch.models.autoreg import AutoRegSegmenter

    t_phase = time.perf_counter()
    batch = full_batch()
    t_out = batch.out_mask.shape[1]
    with tempfile.TemporaryDirectory() as tmp:
        made, _ = build_model(ARSEG_TASK, dev)
        init_from_numpy(made, seed=0)
        made.eval()
        out = made.seg_model.output_layer
        with torch.no_grad():
            out.weight[:2].mul_(ARSEG_OUT_SCALE)
            out.bias[:2].mul_(ARSEG_OUT_SCALE)
            plateaus = []
            for half in (1.0, 0.5):
                (_, logits, _), _ = arseg_decode(made, batch, dev,
                                                 torch.float32, "eager")
                gap = (logits[..., 1] - logits[..., 0])[batch.out_mask]
                plateaus.append(float(np.median(gap)))
                out.bias[1] -= half * plateaus[-1]
            nb_shift = plateaus[0] + 0.5 * plateaus[1]
        ckpt = Path(tmp) / "arseg.pt"
        torch.save({"state_dict": made.state_dict()}, ckpt)
        del made
        model, vocab, _, _ = load_model(Config({
            "task": ARSEG_TASK, "runtime": {"device": dev.type,
                                            "kernels": "auto"}}), ckpt)
    cfg = model.w2v_cfg
    seg = model.seg_model
    check(isinstance(model, AutoRegSegmenter) and cfg.num_layers == 15
          and cfg.hidden_size == 1024 and len(seg.encoder.layers) == 1
          and len(seg.decoder.layers) == 4 and seg.n_dec_heads == 8
          and seg.decoder.layers[0].linear1.out_features == 2048
          and vocab.vocab_size == 4
          and seg.output_layer.out_features == 4,
          "arseg: not AutoRegSegmenter at the xls-r-300m width")
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # the segment path: kernels, eager (counters unmoved), float32
    with tempfile.TemporaryDirectory() as tmp:
        secs = {"talk1.wav": 65.0, "talk2.wav": 41.0}
        wavs = [Path(tmp) / name for name in secs]
        for seed, w in enumerate(wavs):
            write_talk(w, secs[w.name], seed)

        def run(mode: str, dtype):
            backend.set_kernels(mode)
            probs: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = segment_wavs(model, wavs, PTHR, B, 20.0, 1, dev, dtype,
                                talk_probs=probs, loss_tag="ce", vocab=vocab)
            torch.cuda.synchronize()
            backend.set_kernels("auto")
            return rows, probs, (time.perf_counter() - t0) * 1e3

        run("auto", torch.bfloat16)  # warm-up
        backend.reset_launch_counts()
        runs = {"kernels": run("auto", torch.bfloat16)}
        counts = backend.launch_counts()
        runs["eager"] = run("eager", torch.bfloat16)
        check(backend.launch_counts() == counts,
              "the eager arseg run launched kernels")
        runs["f32"] = run("auto", torch.float32)
    for arm, (rows, _, _) in runs.items():
        check({r["wav"] for r in rows} == set(secs),
              f"arseg {arm}: a talk got no segments")
    segment_out = {
        arm: {"segments": len(rows), "wall_ms": ms,
              "dprob_vs_f32": dprob_stats(np.concatenate(
                  [np.abs(p[w] - runs["f32"][1][w]) for w in secs]))}
        for arm, (rows, p, ms) in runs.items()}

    # one full batch: launches, walls, device busy, memory, tokens
    engine_expected = {
        "layer_norm": ARSEG_LN_ENCODE + ARSEG_LN_STEP * t_out,
        "attention_packed": cfg.num_layers, "attention_bthd": 1,
        "ffn": cfg.num_layers, "conv_bias_ln_gelu": 6,
        "conv_audio_ln_gelu": 1}
    # the slice's batches: each talk's windows in one batch (the
    # remainder ladder's 4 rows), at the 20 s or the 22 s bucket
    check(all(counts.get(k, 0) >= SLICE_BATCHES * n
              for k, n in engine_expected.items() if k != "layer_norm")
          and counts.get("layer_norm", 0) >= SLICE_BATCHES * (
              ARSEG_LN_ENCODE + ARSEG_LN_STEP * t_out),
          f"arseg segment path launches {counts}")
    arseg_decode(model, batch, dev, torch.bfloat16, "auto")  # warm-up
    backend.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (kp, kl, kt), k_ms = arseg_decode(model, batch, dev, torch.bfloat16,
                                      "auto")
    per_batch = backend.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(per_batch.get(k, 0) == n for k, n in engine_expected.items()),
          f"arseg batch launches {per_batch}, not {engine_expected}")
    (ep, el, et), e_ms = arseg_decode(model, batch, dev, torch.bfloat16,
                                      "eager")
    (fp, fl, ft), f_ms = arseg_decode(model, batch, dev, torch.float32,
                                      "eager")
    walls = {"kernels": [k_ms], "eager": [e_ms], "f32": [f_ms]}
    for arm, mode, dt in (("kernels", "auto", torch.bfloat16),
                          ("eager", "eager", torch.bfloat16),
                          ("eager", "eager", torch.bfloat16),
                          ("kernels", "auto", torch.bfloat16)):
        walls[arm].append(arseg_decode(model, batch, dev, dt, mode)[1])
    backend.set_kernels("auto")
    audio, lengths, _ = arseg_inputs(batch, dev)
    with torch.inference_mode():
        _, busy, prof_wall = profiled(lambda: model.greedy_decode(
            audio, lengths, t_out, torch.bfloat16))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model._encode(audio, lengths, torch.bfloat16)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
    mask = batch.out_mask
    gap_f32 = (fl[..., 1] - fl[..., 0])[mask]
    tokens = {"kernels_vs_f32": float((kt == ft)[mask].mean()),
              "eager_vs_f32": float((et == ft)[mask].mean()),
              "kernels_vs_eager": float((kt == et)[mask].mean()),
              "nb_share_f32": float((ft == vocab.nonboundary_token_id)[mask]
                                    .mean())}
    for arm, x in (("kernels", kp), ("eager", ep), ("f32", fp)):
        check(bool(np.isfinite(x).all()), f"arseg {arm}: non-finite probs")

    # fidelity on the teacher-forced forward fed the float32 decode's tokens
    forced = {arm: arseg_forced(model, batch, dev, dt, mode, ft)
              for arm, mode, dt in (("kernels", "auto", torch.bfloat16),
                                    ("eager", "eager", torch.bfloat16),
                                    ("f32", "eager", torch.float32))}
    fid = {arm: dprob_stats(np.abs(forced[arm] - forced["f32"])[mask])
           for arm in ("kernels", "eager")}
    fid["f32_decode_vs_forced"] = dprob_stats(np.abs(forced["f32"] - fl)[mask])
    for q in ("mean", "p99"):
        k, e = fid["kernels"][q], fid["eager"][q]
        check(k <= KERNEL_SLACK * e, f"arseg kernels add error to the "
                                     f"teacher-forced logits: {q} {k} vs "
                                     f"{e} on the plain path")
    check(fid["f32_decode_vs_forced"]["max"] <= 1e-3,
          f"arseg float32 decode and teacher-forced forward differ: "
          f"{fid['f32_decode_vs_forced']}")
    phase("arseg", params=sum(p.numel() for p in model.parameters()),
          layers=cfg.num_layers, t_out=t_out, nb_bias_shift=nb_shift,
          calibration_median_gaps=plateaus,
          gap_f32_percentiles_1_5_25_50_75_95_99=[
              float(x) for x in np.percentile(gap_f32,
                                              [1, 5, 25, 50, 75, 95, 99])],
          segment=segment_out, tokens=tokens, fidelity_forced=fid,
          batch_ms=walls, batch_device_busy_ms=busy,
          batch_profiled_wall_ms=prof_wall, encode_ms=encode_ms,
          decode_step_wall_ms=(float(np.median(walls["kernels"]))
                               - encode_ms) / t_out,
          peak_mem_gb=peak, launches_batch=per_batch,
          launches_segment=counts)

    # training: three micro-steps, bf16 kernels / bf16 eager / float32
    with tempfile.TemporaryDirectory() as tmp:
        talks, segments = write_corpus(Path(tmp))
        gen = RandomDataloaderGenerator(talks, segments, TRAIN_WINDOW, B,
                                        seed=0, vocab=vocab,
                                        autoregression=True)
        batches = list(gen.generate())[:TRAIN_STEPS]
    runs = {arm: arseg_train(dev, model, sd, batches, mode, dt)
            for arm, mode, dt in (("kernels", "auto", torch.bfloat16),
                                  ("eager", "eager", torch.bfloat16),
                                  ("f32", "eager", torch.float32))}
    k = runs["kernels"]
    n_dec = len(seg.decoder.layers)
    # K4 and K10: the encoder's self-attention and each decoder layer's
    # cross-attention; K9: the encoder layer's 2, the shared LayerNorm's 2
    # and 3 a decoder layer, the first (on the frozen backbone's output)
    # without dx (counted under both names)
    want = {"attention_bthd": 1 + n_dec, "attention_bwd": 1 + n_dec,
            "layer_norm_bwd": 3 * n_dec + 4, "layer_norm_bwd_no_dx": 1}
    for i, launches in enumerate(k["launches"]):
        check(all(launches.get(n, 0) == c for n, c in want.items()),
              f"arseg micro-step {i}: launches {launches}, want {want}")
    for arm, r in runs.items():
        check(r["backbone_unchanged"] and r["head_moved"],
              f"arseg training {arm}: the backbone moved or the head did "
              f"not")
        if arm != "kernels":
            check(all(not any(x.values()) for x in r["launches"]),
                  f"arseg training {arm}: eager launched kernels")
    k_vs_f = grad_dist(k["grads"], runs["f32"]["grads"])
    e_vs_f = grad_dist(runs["eager"]["grads"], runs["f32"]["grads"])
    check(k_vs_f <= KERNEL_SLACK * e_vs_f,
          f"arseg training: kernels' first gradients {k_vs_f} from float32, "
          f"the plain path's {e_vs_f}")
    phase("arseg_train", batch=B, micro_steps=len(batches),
          loss={a: r["loss"] for a, r in runs.items()},
          grad_dist_kernels_vs_f32=k_vs_f, grad_dist_eager_vs_f32=e_vs_f,
          ms_per_micro_step={a: r["ms"] for a, r in runs.items()},
          device_busy_ms={a: r["device_busy_ms"] for a, r in runs.items()},
          peak_gb={a: r["peak_gb"] for a, r in runs.items()},
          launches=k["launches"][0], seconds=time.perf_counter() - t_phase)
    return counts


def run_base(dev) -> dict:
    """The base models' geometry at full width: SHAS on facebook/wav2vec2-
    base (12 post-LN layers of 768, the group-norm conv stack without conv
    bias; conf/task/shas.yaml's head of 8 heads of 96), seeded random
    weights, output layer x40 as in the slice.  (a) The slice's two talks
    through segment_wavs at batch 14 with pTHR: bf16 kernels (launch
    counters reset just before), bf16 eager (counters unmoved), float32;
    the slice's |dprob| rules, and the kernels' yaml rows against eager's
    within tests/test_packing.py's bounds.  (b) One full batch of 14 x 20 s
    in bf16, kernels and eager in turns: wall ms, device busy ms and idle
    share of a profiled batch of each, the conv stack's plain group route
    alone (its share of the kernels' busy ms); mean and p99 |dprob| of
    both against the eager float32 batch (the kernels within KERNEL_SLACK
    of eager); the batch's launches (K1 28, K3 12, K5 12, K4 1 at D = 96,
    row_dot 1, no conv kernel).  (c) Reported: whether a window's
    probabilities are bitwise the same alone as in a batch of 8.  Returns
    the launches of (a)."""
    from wav2vecsegmenter_tpu_torch.data.collate import collate, out_len_for
    from wav2vecsegmenter_tpu_torch.data.windows import BatchIterator
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import feature_extractor

    t_phase = time.perf_counter()
    model = SHAS(wav2vec_model_name=BASE_MODEL, device=dev)
    init_from_numpy(model, seed=0)
    with torch.no_grad():
        model.seg_model.output_layer.weight.mul_(40.0)
    model.eval()
    cfg = model.w2v_cfg
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.ffn_dim,
           cfg.feat_extract_norm, cfg.do_stable_layer_norm, cfg.conv_bias)
          == (768, 12, 12, 3072, "group", False, False)
          and cfg.hidden_size // model.seg_model.n_heads == BASE_HEAD_DIM,
          "not the base geometry at full width")
    want = batch_launches(model)

    # (a) the slice's talks
    secs = {"talk1.wav": 65.0, "talk2.wav": 41.0}
    with tempfile.TemporaryDirectory() as tmp:
        wavs = [Path(tmp) / name for name in secs]
        for seed, w in enumerate(wavs):
            write_talk(w, secs[w.name], seed)

        def run(mode: str, dtype=torch.bfloat16):
            backend.set_kernels(mode)
            probs: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = segment_wavs(model, wavs, PTHR, B, 20.0, 1, dev, dtype,
                                talk_probs=probs)
            torch.cuda.synchronize()
            backend.set_kernels("auto")
            return rows, probs, time.perf_counter() - t0

        run("auto")  # warm-up
        backend.reset_launch_counts()
        rows_k, probs_k, wall_k = run("auto")
        counts = backend.launch_counts()
        rows_e, probs_e, wall_e = run("eager")
        check(backend.launch_counts() == counts,
              "the eager base run launched kernels")
        rows_f, probs_f, _ = run("auto", torch.float32)
    for name, n in want.items():
        check(counts.get(name, 0) == n * SLICE_BATCHES,
              f"base segment path: {name} launched {counts.get(name, 0)} "
              f"times, not {n} a batch")
    check(not counts.get("bias_layer_norm_gelu"),
          "base segment path: the conv epilogue kernel launched")
    for rows in (rows_k, rows_e, rows_f):
        check({r["wav"] for r in rows} == set(secs),
              "base: a talk got no segments")
    for probs in (probs_k, probs_e, probs_f):
        for name in secs:
            check(probs[name].shape == (round(secs[name] * 49.95),)
                  and bool(np.isfinite(probs[name]).all()),
                  "base: probs shape or non-finite")

    def dprob(a, b):
        return dprob_stats(np.concatenate([np.abs(a[n] - b[n])
                                           for n in secs]))

    talks = {"kernels_vs_f32": dprob(probs_k, probs_f),
             "eager_vs_f32": dprob(probs_e, probs_f),
             "kernels_vs_eager": dprob(probs_k, probs_e)}
    gap = row_gap(rows_k, rows_e, secs)

    # (b) one full batch
    batch = full_batch()
    engine = WindowInference(model, dev, torch.bfloat16)

    def once(mode, dtype=torch.bfloat16):
        backend.set_kernels(mode)
        eng = engine if dtype == torch.bfloat16 else WindowInference(
            model, dev, dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = eng.run_batch(batch).numpy()
        ms = (time.perf_counter() - t0) * 1e3
        backend.set_kernels("auto")
        return probs, ms

    oracle, _ = once("eager", torch.float32)
    once("auto")
    once("eager")
    backend.reset_launch_counts()
    probs_bk, _ = once("auto")
    launches = {k: v for k, v in backend.launch_counts().items() if v}
    probs_be, _ = once("eager")
    ms = {"auto": [], "eager": []}
    for mode in ("auto", "eager", "eager", "auto", "auto", "eager"):
        ms[mode].append(once(mode)[1])
    traced = {mode: profiled(lambda m=mode: once(m))[1:]
              for mode in ("auto", "eager")}
    busy = traced["auto"][0]
    mask = batch.out_mask
    fidelity = {arm: dprob_stats(np.abs(p - oracle)[mask])
                for arm, p in (("kernels", probs_bk), ("eager", probs_be))}
    coll = collate(full_batch_examples(), B, L_AUDIO, out_len_for(L_AUDIO))
    audio = torch.from_numpy(coll.audio).to(dev)
    with torch.inference_mode():
        conv_ms = cuda_ms(lambda: feature_extractor(
            model.backbone.feature_extractor, audio, cfg, torch.bfloat16), 5)
    del audio

    # (c) a window alone and in a batch of 8
    examples = full_batch_examples()
    eight, = BatchIterator(examples[:8], 8, 20.0)
    alone, = BatchIterator(examples[:1], 1, 20.0)
    p8 = engine.run_batch(eight).numpy()[0]
    p1 = engine.run_batch(alone).numpy()[0]
    med = {m: float(np.median(v)) for m, v in ms.items()}
    phase("base", model=BASE_MODEL, layers=cfg.num_layers,
          hidden=cfg.hidden_size, head_dim=BASE_HEAD_DIM,
          params=sum(p.numel() for p in model.parameters()),
          segments_kernels=len(rows_k), segments_eager=len(rows_e),
          segments_f32=len(rows_f), dprob_talks=talks,
          rows_kernels_vs_eager=gap,
          rows_eager_vs_f32=row_gap(rows_e, rows_f, secs),
          wall_s_kernels=wall_k, wall_s_eager=wall_e,
          audio_per_wall_kernels=sum(secs.values()) / wall_k,
          launches=counts, batch_launches=launches,
          batch_ms_kernels=ms["auto"], batch_ms_eager=ms["eager"],
          batch_ms_median={"kernels": med["auto"], "eager": med["eager"]},
          device_busy_ms={("kernels" if m == "auto" else m): b
                          for m, (b, _) in traced.items()},
          profiled_wall_ms={("kernels" if m == "auto" else m): w
                            for m, (_, w) in traced.items()},
          idle_share={("kernels" if m == "auto" else m): 1 - b / w
                      for m, (b, w) in traced.items()},
          conv_stack_ms=conv_ms,
          conv_stack_share=conv_ms / busy,
          dprob_batch_vs_f32_eager=fidelity,
          window_alone_bitwise_as_in_8=bool(np.array_equal(p1, p8)),
          window_alone_vs_8_max_abs=float(np.abs(p1 - p8).max()),
          seconds=time.perf_counter() - t_phase)
    check(launches == {k: v for k, v in want.items() if v},
          f"base batch launches {launches}, not {want}")
    for q in ("mean", "p99"):
        k_f, e_f = (talks[f"{a}_vs_f32"][q] for a in ("kernels", "eager"))
        check(k_f <= KERNEL_SLACK * e_f,
              f"base kernels add error: {q} dprob to float32 {k_f} vs "
              f"{e_f} on the plain path")
        check(talks["kernels_vs_eager"][q] <= e_f,
              f"base kernel vs eager {q} dprob "
              f"{talks['kernels_vs_eager'][q]} exceeds the bf16 envelope "
              f"{e_f}")
        k, e = (fidelity[a][q] for a in ("kernels", "eager"))
        check(k <= KERNEL_SLACK * e,
              f"base batch: kernels {q} dprob {k} vs eager's {e}")
    check(gap["beyond_bounds"] == 0 and gap["count_gap"] <= 1,
          f"base: kernels' rows against eager's {gap}, beyond "
          f"tests/test_packing.py's bounds")
    return counts


# base_train: facebook/wav2vec2-base (12 post-LN layers of 768, the
# group-norm conv stack) under conf/task/shas.yaml's head (8 heads of 96):
# (a) frozen; (b) LNA, every layer fine-tuned, FFNs and the feature encoder
# frozen; (c) the default task's adapters (not applied on a post-LN layer:
# they move by weight decay alone) with the feature encoder trained.  The
# SSL tasks on base-960h (frozen) and base (ctc, fine-tuned), arseg frozen.
BASE_TASK = {**SHAS_TASK["model"], "wav2vec_model_name": BASE_MODEL}
BASE_LNA_TASK = {**BASE_TASK, "finetune_wav2vec": True,
                 "wav2vec_ft_layers": 12, "ffn_adapter": False}
BASE_FEAT_TASK = {**BASE_TASK, "finetune_wav2vec": True,
                  "wav2vec_ft_layers": 12, "finetune_w2v_feat_enc": True}
BASE_SSL_TASK = {**SSL_TASK, "model": {
    **SSL_TASK["model"], "wav2vec_model_name": BASE_MODEL + "-960h"}}
BASE_CTC_TASK = {**CTC_TASK, "model": {
    **CTC_TASK["model"], "wav2vec_model_name": BASE_MODEL}}
BASE_ARSEG_TASK = {**ARSEG_TASK, "model": {
    **ARSEG_TASK["model"], "wav2vec_model_name": BASE_MODEL}}
# the base encoder's LayerNorm of the unapplied pre-layers kind
BASE_PRE_LN = "wav2vec_model.model.encoder.layer_norm."


def base_launches(feat_enc: bool) -> dict:
    """A base LNA micro-step's launches: the LNA path's at 12 layers (K1
    28: the projection's, two in each post-LN layer, the head's three),
    with no conv kernel (the group-norm stack takes none) and no K5 (the
    base models' activation dropout, 0.1, takes the FFN to its two GEMMs
    with the dropout between them in train mode, as in the JAX package);
    K10 13 (12 at D=64, the head's at D=96)."""
    return {**lna_launches(12, feat_enc), "conv_bias_ln_gelu": 0,
            "conv_audio_ln_gelu": 0, "ffn": 0}


def moved_check(model, fresh, trained: set, tag: str) -> dict:
    """Frozen parameters bitwise unchanged, trained ones moved (but for a
    zero parameter that gets no gradient: the unapplied encoder.layer_norm's
    bias, which weight decay leaves at 0); counts."""
    n = {"frozen": 0, "trained": 0}
    for (name, p), (_, p0) in zip(model.named_parameters(),
                                  fresh.named_parameters()):
        same = torch.equal(p, p0)
        if name.startswith(BASE_PRE_LN) and not p0.any():
            check(same, f"{tag}: {name} moved from 0 with no gradient")
            n["trained"] += 1
            continue
        check(same != (name in trained),
              f"{tag}: {name} {'moved' if not same else 'did not move'} "
              f"({'trained' if name in trained else 'frozen'})")
        n["trained" if name in trained else "frozen"] += 1
    return n


def run_base_train(dev) -> dict:
    """The base_train phase ((a)-(e) of the module docstring); returns
    the launches of the LNA bf16 kernels run at batch 14."""
    from wav2vecsegmenter_tpu_torch.cli.common import build_model
    from wav2vecsegmenter_tpu_torch.data.loader import (
        RandomDataloaderGenerator)

    t0 = time.perf_counter()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for sub in ("two", "six", "text"):
            (root / sub).mkdir()
        split = dict(zip(("talk_list", "segments_list"),
                         write_corpus(root / "two", LNA_TALKS)),
                     segment_length=TRAIN_WINDOW)
        split14 = dict(zip(("talk_list", "segments_list"),
                           write_corpus(root / "six")),
                       segment_length=TRAIN_WINDOW)
        text = dict(zip(("talk_list", "segments_list"),
                        write_corpus(root / "text", CTC_TALKS, texts=True)),
                    segment_length=TRAIN_WINDOW)

        # (a) the head on a frozen backbone, batch 14
        a = lna_run(dev, tmp, split14, BASE_TASK, B, 2, "auto", "bfloat16",
                    profile=True, tag="_base_frozen")
        a.pop("model")
        want_a = {"attention_bwd": 1, "attention_bthd": 1,
                  "attention_packed": 12, "ffn": 0, "layer_norm": 28,
                  "layer_norm_bwd": 3, "layer_norm_bwd_no_dx": 1,
                  "conv_bias_ln_gelu": 0, "conv_audio_ln_gelu": 0}
        for i, got in enumerate(a["steps"]):
            check({n: got[n] for n in want_a} == want_a,
                  f"base frozen micro-step {i} launches {got}")
        out["frozen_b14"] = {
            **step_times(a, TIMED_SKIP), "loss": a["history"]["loss"],
            "peak_mem_gb": a["peak_gb"],
            "device_busy_ms": a["profiled"]["busy_ms"],
            "profiled_ms": a["history"]["step_seconds"][PROFILED] * 1e3,
            "top_ops": a["profiled"]["top_ops"]}

        # (b) LNA, every layer, batch 14 and 4, four arms each
        want = base_launches(feat_enc=False)
        for batch, sp in ((B, split14), (LNA_B, split)):
            runs = {}
            for mode, dtype in (("auto", "bfloat16"), ("eager", "bfloat16"),
                                ("auto", "float32"), ("eager", "float32")):
                kernels = (mode, dtype) == ("auto", "bfloat16")
                r = lna_run(dev, tmp, sp, BASE_LNA_TASK, batch, 2, mode,
                            dtype, profile=kernels, tag="_base")
                check(r["steps_per_epoch"] == [3, 3] and r["updates"] == 4,
                      f"base LNA batch {batch}: {r['steps_per_epoch']}")
                model = r.pop("model")
                if kernels:
                    for i, got in enumerate(r["steps"]):
                        check({n: got[n] for n in want} == want,
                              f"base LNA batch {batch} micro-step {i} "
                              f"launches {got}, not {want}")
                    fresh, _ = build_model(BASE_LNA_TASK, dev)
                    init_from_numpy(fresh, seed=0)
                    trained = {n for n, p in model.named_parameters()
                               if p.requires_grad}
                    counts = moved_check(model, fresh, trained,
                                         f"base LNA batch {batch}")
                    check(not any(".feed_forward." in n or ".feature_" in n
                                  for n in trained) and
                          BASE_PRE_LN + "weight" in trained,
                          "base LNA: not the split asked for")
                    names = [n for n, p in model.named_parameters()
                             if p.requires_grad]
                    pre = r["grads"][names.index(BASE_PRE_LN + "weight")]
                    check(not pre.any(), "base LNA: the unapplied "
                                         "encoder.layer_norm got a gradient")
                    del fresh
                del model
                torch.cuda.empty_cache()
                runs[mode, dtype] = r
            k = runs["auto", "bfloat16"]
            k_vs_f = grad_dist(k["grads"], runs["auto", "float32"]["grads"])
            e_vs_f = grad_dist(runs["eager", "bfloat16"]["grads"],
                               runs["auto", "float32"]["grads"])
            f32_k_vs_e = grad_dist(runs["auto", "float32"]["grads"],
                                   runs["eager", "float32"]["grads"])
            check(k_vs_f <= KERNEL_SLACK * e_vs_f,
                  f"base LNA batch {batch}: kernels add error to the "
                  f"gradients: {k_vs_f} from float32 vs {e_vs_f}")
            check(f32_k_vs_e <= F32_GRAD,
                  f"base LNA batch {batch}: float32 kernels vs eager "
                  f"gradients {f32_k_vs_e} > {F32_GRAD}")
            out[f"lna_b{batch}"] = {
                **step_times(k, TIMED_SKIP),
                "ms_per_micro_step_eager": step_times(
                    runs["eager", "bfloat16"])["ms_per_micro_step"],
                "ms_per_micro_step_f32": step_times(
                    runs["auto", "float32"])["ms_per_micro_step"],
                "loss": {f"{m}_{d}": r["history"]["loss"]
                         for (m, d), r in runs.items()},
                "grad_dist_kernels_vs_f32": k_vs_f,
                "grad_dist_eager_vs_f32": e_vs_f,
                "grad_dist_f32_kernels_vs_eager": f32_k_vs_e,
                "peak_mem_gb": k["peak_gb"],
                "device_busy_ms": k["profiled"]["busy_ms"],
                "profiled_ms": k["history"]["step_seconds"][PROFILED] * 1e3,
                "top_ops": k["profiled"]["top_ops"], "params": counts}
            if batch == B:
                launches = k["launches"]
            for r in runs.values():
                del r["grads"]

        # (c) the feature encoder and the adapters, one epoch at batch 4
        c = lna_run(dev, tmp, split, BASE_FEAT_TASK, LNA_B, 1, "auto",
                    "bfloat16", tag="_base_feat")
        want_c = base_launches(feat_enc=True)
        for i, got in enumerate(c["steps"]):
            check({n: got[n] for n in want_c} == want_c,
                  f"base feature-encoder micro-step {i} launches {got}")
        model = c.pop("model")
        fresh, _ = build_model(BASE_FEAT_TASK, dev)
        init_from_numpy(fresh, seed=0)
        trained = {n for n, p in model.named_parameters() if p.requires_grad}
        moved_check(model, fresh, trained, "base feature encoder")
        check(any(".feature_extractor.conv_layers.0.layer_norm." in n
                  for n in trained)
              and any(".ffn_adapter." in n for n in trained),
              "base feature encoder: the group-norm stack or the adapters "
              "were not trained")
        out["feat_enc_b4"] = {"loss": c["history"]["loss"],
                              "peak_mem_gb": c["peak_gb"],
                              **step_times(c, (0,))}
        del model, fresh
        torch.cuda.empty_cache()

        # (d) shas_ssl (base-960h, frozen, batch 14), shas_ctc (fine-tuned,
        # batch 4) and arseg (frozen, batch 14): three micro-steps each
        for tag, task, sp, batch in (("ssl", BASE_SSL_TASK, split14, B),
                                     ("ctc", BASE_CTC_TASK, text, CTC_B)):
            r = ssl_train_run(dev, tmp, sp, task, batch, "auto", "bfloat16")
            check(r["updates"] == 3 and r["launches"]["attention_bwd"] > 0,
                  f"base {tag}: {r['updates']} updates, launches "
                  f"{r['launches']}")
            out[tag] = {"loss": r["history"]["loss"],
                        "grad_norm": r["history"]["grad_norm"],
                        "launches": r["launches"], "peak_mem_gb": r["peak_gb"],
                        **step_times(r, (0,))}
            del r
            torch.cuda.empty_cache()
        ar, vocab = build_model(BASE_ARSEG_TASK, dev)
        init_from_numpy(ar, seed=0)
        sd = {k: v.detach().clone() for k, v in ar.state_dict().items()}
        gen = RandomDataloaderGenerator(split14["talk_list"],
                                        split14["segments_list"],
                                        TRAIN_WINDOW, B,
                                        seed=0, vocab=vocab,
                                        autoregression=True)
        batches = list(gen.generate())[:TRAIN_STEPS]
        r = arseg_train(dev, ar, sd, batches, "auto", torch.bfloat16)
        n_dec = len(ar.seg_model.decoder.layers)
        want_ar = {"attention_bthd": 1 + n_dec, "attention_bwd": 1 + n_dec,
                   "layer_norm_bwd": 3 * n_dec + 4, "layer_norm_bwd_no_dx": 1}
        for i, got in enumerate(r["launches"]):
            check(all(got.get(n, 0) == m for n, m in want_ar.items()),
                  f"base arseg micro-step {i}: launches {got}")
        check(r["backbone_unchanged"] and r["head_moved"],
              "base arseg: the backbone moved or the head did not")
        out["arseg"] = {"loss": r["loss"], "ms": r["ms"],
                        "device_busy_ms": r["device_busy_ms"],
                        "profiled_wall_ms": r["profiled_wall_ms"],
                        "peak_mem_gb": r["peak_gb"],
                        "launches": r["launches"][0]}
        del r

        # (e) one arseg decode batch through segment_wavs, bf16 kernels
        ar.load_state_dict(sd)
        ar.eval()
        talk = root / "talk.wav"
        write_talk(talk, 19.0, seed=5)
        probs: dict = {}
        backend.reset_launch_counts()
        torch.cuda.synchronize()
        t_dec = time.perf_counter()
        rows = segment_wavs(ar, [talk], PTHR, B, 20.0, 1, dev,
                            torch.bfloat16, talk_probs=probs, loss_tag="ce",
                            vocab=vocab)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t_dec) * 1e3
        dec = backend.launch_counts()
        p = probs[talk.name]
        check(p.shape == (round(19.0 * 49.95),) and bool(np.isfinite(p).all())
              and rows is not None, "base arseg decode: probs")
        check(dec["attention_bthd"] >= 1 and dec["attention_packed"] >= 12
              and not dec["conv_bias_ln_gelu"],
              f"base arseg decode launches {dec}")
        out["arseg_decode"] = {"wall_ms": dec_ms, "launches": {
            n: v for n, v in dec.items() if v}, "segments": len(rows)}
        del ar
        torch.cuda.empty_cache()
    phase("base_train", model=BASE_MODEL, head_dim=BASE_HEAD_DIM,
          launches_per_micro_step=want,
          launches_per_micro_step_feat_enc=want_c,
          seconds=time.perf_counter() - t0, **out)
    return launches


# ---------------------------------------------------------------- mesh (18)

# the slice's talks; two ranks on the one card (gloo: NCCL refuses two
# ranks on one device); the port's kernels the profiled train run's trace
# must name
MESH_TALKS = {"talk1.wav": 65.0, "talk2.wav": 41.0}
MESH_RANKS = 2
# a mesh LNA step's loss (the global batch's, its rows' sums in another
# order) against the one-rank step's, bf16
MESH_LOSS_RTOL = 1e-3
# a mesh step's grad_norm (its ranks' squares summed over the mesh)
# against the norm of its gradients gathered whole: float32 sums of the
# same squares in another order
MESH_NORM_RTOL = 1e-4
TRACE_KERNELS = ("attn_fwd_tc_kernel", "ffn_wg_kernel", "ln_vec_kernel")


def mesh_model(dev, task: dict | None = None) -> SHAS:
    """The slice's full-width SHAS (seed 0, the output layer x40), or the
    SHAS of ``task`` (seed 0)."""
    model = SHAS(**(task or {}), device=dev)
    init_from_numpy(model, seed=0)
    if task is None:
        with torch.no_grad():
            model.seg_model.output_layer.weight.mul_(40.0)
    return model


def mesh_train_batch(n: int, seed: int = 3):
    """n windows of 20 s with speech-burst targets, collated as the
    trainer reads them."""
    from wav2vecsegmenter_tpu_torch.data.collate import collate, out_len_for

    rng = np.random.RandomState(seed)
    env_ = (np.arange(L_AUDIO) / 16000 % 3.5) < 3.0
    t_out = out_len_for(L_AUDIO)
    target = ((np.arange(t_out) / 49.95 % 3.5) < 3.0).astype(np.float32)
    examples = [((rng.randn(L_AUDIO) * 0.1 * env_).astype(np.float32),
                 target, 0, t_out) for _ in range(n)]
    return collate(examples, n, L_AUDIO, t_out, device_normalize=True)


def mesh_segment(model, wavs, dev, dtype=torch.bfloat16, mesh=None,
                 read_seconds=None):
    """(rows, talk probabilities, wall s) of the slice's sweep at batch 14,
    pTHR, on ``mesh`` (each batch's read s onto ``read_seconds``)."""
    probs: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = segment_wavs(model, wavs, PTHR, B, 20.0, 1, dev, dtype,
                        talk_probs=probs, mesh=mesh,
                        read_seconds=read_seconds)
    torch.cuda.synchronize()
    return rows, probs, time.perf_counter() - t0


def dprob_to(probs: dict, ref: dict) -> dict:
    d = np.concatenate([np.abs(probs[n] - ref[n]) for n in sorted(ref)])
    return {"mean": float(d.mean()), "p99": float(np.percentile(d, 99)),
            "max": float(d.max())}


def frozen_steps(model, dev, mesh=None, n: int = 3) -> list:
    """``n`` micro-steps of the head on the frozen backbone (bf16, the
    kernels, dropout from seed 0) from the model's weights, which are put
    back after: each step's loss and head gradients."""
    from wav2vecsegmenter_tpu_torch.train import loss as tloss
    from wav2vecsegmenter_tpu_torch.train import step as tstep

    saved = {k: v.clone() for k, v in model.state_dict().items()}
    params = model.set_requires_grad()
    opt = tstep.AccumulatingAdamW(params, 2.5e-4, 10, 1)
    step = tstep.make_train_step(
        model, tloss.BCEWithLogitsLoss(None), 0, opt, torch.bfloat16,
        torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    out = []
    for i in range(n):
        m = step(mesh_train_batch(B, seed=20 + i), 0.5)
        out.append((m["loss"].clone(), [g.clone() for g in m["grads"]]))
    model.load_state_dict(saved)
    model.eval()
    return out


def time_engine(engine, batch, n: int = 3) -> float:
    """Median ms of a full batch through ``engine``, to its probabilities
    on the host."""
    engine.run_batch(batch).numpy()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_batch(batch).numpy()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def allreduce_share(engine, batch) -> float:
    """The share of one tensor-parallel batch's wall that its model-axis
    all-reduces take (each timed from a synchronize to a synchronize)."""
    from wav2vecsegmenter_tpu_torch.ops import shmap

    spent = [0.0]
    reduce = shmap.all_reduce

    def timed(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(t, group)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    shmap.all_reduce = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_batch(batch).numpy()
        wall = time.perf_counter() - t0
    finally:
        shmap.all_reduce = reduce
    return spent[0] / wall


def mesh_lna_step(dev, mesh, mode: str = "auto", dtype=torch.bfloat16,
                  fsdp: bool = False) -> dict:
    """One micro-step of conf/task/shas.yaml's LNA split (its top 8
    layers with their FFNs and adapters, the feature encoder) on 4 windows
    on ``mesh`` (``fsdp``: the model ``fully_shard``-ed over 'data'): its
    loss, grad_norm, launches, and its first gradients gathered whole in
    float32 (on 'data' each rank's are the global batch's) with their
    norm."""
    from wav2vecsegmenter_tpu_torch.parallel import mesh as pmesh
    from wav2vecsegmenter_tpu_torch.train import loss as tloss
    from wav2vecsegmenter_tpu_torch.train import step as tstep

    backend.set_kernels(mode)
    model = mesh_model(dev, LNA_DEFAULT_TASK)
    model.set_requires_grad()
    pmesh.shard_model(model, mesh)
    if fsdp:
        pmesh.apply_fsdp(model, mesh)
    params = model.trainable_parameters()
    names = [n for n, _ in model.named_parameters() if model._trains(n)]
    opt = tstep.AccumulatingAdamW(params, 2.5e-4, 10, 1)
    step = tstep.make_train_step(
        model, tloss.BCEWithLogitsLoss(None), 0, opt, dtype,
        torch.Generator(device=dev).manual_seed(0), mesh=mesh, fsdp=fsdp)
    backend.reset_launch_counts()
    m = step(mesh_train_batch(LNA_B), 0.5)
    counts = backend.launch_counts()
    backend.set_kernels("auto")
    split = pmesh.split_parameters(model)
    grads = [pmesh.full_tensor(n, g, split.get(n)).float()
             for n, g in zip(names, m["grads"])]
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "launches": counts, "grads": grads,
            "full_norm": float(torch.sqrt(sum(g.square().sum()
                                              for g in grads)))}


def sweep_windows(wavs, n_data: int = 1, data_rank: int = 0) -> int:
    """The windows a data rank reads in the slice's sweep at batch B: its
    rows of every batch (all of them on one rank)."""
    from wav2vecsegmenter_tpu_torch.data.windows import (
        BatchIterator, FixedSegmentationDatasetNoTarget)

    total = 0
    for w in wavs:
        ds = FixedSegmentationDatasetNoTarget(w, 20.0, 1)
        ds.fixed_length_segmentation(0)
        it = BatchIterator(ds, B, 20.0, n_data=n_data, data_rank=data_rank)
        total += sum(len(it._own_rows(idx)) for idx in it._index_batches())
    return total


def sweep_reads_alone(wavs, n_data: int = 1, data_rank: int = 0) -> dict:
    """A data rank's batches of the slice's sweep at batch B, built
    serially with nothing else in flight as ``segment_wavs`` builds them
    (pinned; each window read alone on a data rank): ms a batch to read
    its windows (``windows_ms``) and to read, collate and pin its rows
    (``batch_ms``), the medians over three passes after one to warm up."""
    from wav2vecsegmenter_tpu_torch.data.windows import (
        BatchIterator, FixedSegmentationDatasetNoTarget)

    windows, batches = [], []
    for rep in range(4):
        for w in wavs:
            ds = FixedSegmentationDatasetNoTarget(w, 20.0, 1,
                                                  whole_talk=n_data == 1)
            ds.fixed_length_segmentation(0)
            it = BatchIterator(ds, B, 20.0, pin_memory=True, n_data=n_data,
                               data_rank=data_rank)
            for idx in it._index_batches():
                own = it._own_rows(idx) if n_data > 1 else idx
                t0 = time.perf_counter()
                for j in own:
                    ds[j]
                t1 = time.perf_counter()
                it._batch(idx, lambda ix: [ds[j] for j in ix])
                if rep:
                    windows.append(t1 - t0)
                    batches.append(time.perf_counter() - t1)
    return {"windows_ms": float(np.median(windows)) * 1e3,
            "batch_ms": float(np.median(batches)) * 1e3}


def mesh_rank(argv: list) -> dict:
    """One of the mesh phase's two ranks on the one card, run by
    ``core.runtime.launch_ranks`` over gloo; ``argv`` holds the talks'
    paths.  Rank 0 also runs the one-rank references (the others wait).
    Each mesh run's sweep records every rank's reader route, windows read
    and read ms a batch (``reads``)."""
    from torch import distributed as dist

    from wav2vecsegmenter_tpu_torch.core import runtime
    from wav2vecsegmenter_tpu_torch.data.audio import reader_backend
    from wav2vecsegmenter_tpu_torch.data.windows import (
        FixedSegmentationDatasetNoTarget)
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu_torch.parallel import mesh as pmesh

    reads: list = []
    getitem = FixedSegmentationDatasetNoTarget.__getitem__

    def counted(self, idx):
        reads.append(int(idx))
        return getitem(self, idx)

    FixedSegmentationDatasetNoTarget.__getitem__ = counted

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runtime.maybe_init_distributed("cuda")
    dev = runtime.rank_device(torch.device("cuda"))
    rank0 = runtime.is_rank0()
    wavs = [Path(w) for w in argv]
    out: dict = {"backend": dist.get_backend()}
    model = mesh_model(dev).eval()
    ref: dict = {}
    if rank0:
        mesh_segment(model, wavs, dev)
        read_s: list = []
        ref["rows"], ref["bf16"], _ = mesh_segment(model, wavs, dev,
                                                   read_seconds=read_s)
        _, ref["f32"], _ = mesh_segment(model, wavs, dev, torch.float32)
        out["one_vs_f32"] = dprob_to(ref["bf16"], ref["f32"])
        out["one_read_ms_per_batch"] = float(np.median(read_s)) * 1e3
    dist.barrier()
    batch = full_batch()
    for name, conf in (("dp", {"data": 2}), ("tp", {"data": 1,
                                                     "model": 2})):
        mesh, _, _ = pmesh.resolve_mesh(conf, MESH_RANKS, "cuda")
        if name == "tp":
            pmesh.shard_model(model, mesh)
        mesh_segment(model, wavs, dev, mesh=mesh)  # warm-up
        reads.clear()
        read_s: list = []
        backend.reset_launch_counts()
        rows, probs, wall = mesh_segment(model, wavs, dev, mesh=mesh,
                                         read_seconds=read_s)
        counts = backend.launch_counts()
        mine = {"reader_backend": reader_backend(),
                "windows_read": len(reads),
                "read_ms_per_batch": float(np.median(read_s)) * 1e3}
        per_rank = [None] * MESH_RANKS
        dist.all_gather_object(per_rank, mine)
        engine = WindowInference(model, dev, torch.bfloat16, mesh=mesh)
        ms = [None] * MESH_RANKS
        dist.all_gather_object(ms, time_engine(engine, batch))
        res = {"segments": len(rows), "wall_s": wall,
               "batch_ms_per_rank": ms, "launches": counts,
               "reads": per_rank}
        if name == "tp":
            res["allreduce_share"] = allreduce_share(engine, batch)
        if rank0:
            res["vs_f32"] = dprob_to(probs, ref["f32"])
            res["vs_one"] = dprob_to(probs, ref["bf16"])
            res["rows_vs_one"] = row_gap(rows, ref["rows"], MESH_TALKS)
        out[name] = res
    del model, engine
    torch.cuda.empty_cache()
    out.update(mesh_lna_runs(dev, MESH_LNA_RUNS, MESH_RANKS))
    return out


# the mesh LNA steps on the two ranks: (name, runtime.mesh, fsdp)
MESH_LNA_RUNS = (("lna_tp", {"data": 1, "model": 2}, False),
                 ("lna_dp", {"data": 2}, False),
                 ("fsdp", {"data": 2}, True))


def mesh_lna_runs(dev, runs, n_ranks: int) -> dict:
    """The LNA micro-step on rank 0 alone (``lna_one``: bf16 with the
    kernels, and eager float32) and on each mesh of ``runs`` (name,
    ``runtime.mesh``, fsdp) over the group's ``n_ranks`` ranks: the
    figures :func:`check_lna_runs` holds, rank 0's complete."""
    from torch import distributed as dist

    from wav2vecsegmenter_tpu_torch.parallel import mesh as pmesh

    rank0 = dist.get_rank() == 0
    out: dict = {}
    if rank0:
        one = mesh_lna_step(dev, None)
        f32 = mesh_lna_step(dev, None, "eager", torch.float32)
        out["lna_one"] = {"loss": one["loss"], "grad_norm": one["grad_norm"],
                          "loss_f32": f32["loss"],
                          "grad_norm_f32": f32["grad_norm"],
                          "dist": grad_dist(one["grads"], f32["grads"])}
        del one
        torch.cuda.empty_cache()
    dist.barrier()
    for name, conf, fsdp in runs:
        mesh, _, _ = pmesh.resolve_mesh(conf, n_ranks, "cuda")
        run = mesh_lna_step(dev, mesh, fsdp=fsdp)
        grads = run.pop("grads")
        if rank0:
            run["dist"] = grad_dist(grads, f32["grads"])
        out[name] = run
        del grads
        torch.cuda.empty_cache()
    return out


def check_lna_runs(ranks: dict, names) -> None:
    """Hold each mesh LNA step ``names`` of :func:`mesh_lna_runs` to the
    one-rank step: the trainer's kernels launched on its shards; its loss;
    its gradients' distance to float32's; its grad_norm against its
    gradients gathered whole and against the one-rank step's."""
    one = ranks["lna_one"]
    for name in names:
        run = ranks[name]
        for k in ("layer_norm_bwd", "attention_bwd", "attention_packed",
                  "ffn"):
            check(run["launches"].get(k, 0) > 0,
                  f"kernel {k} never launched on the {name} step")
        check(abs(run["loss"] - one["loss"])
              <= MESH_LOSS_RTOL * abs(one["loss"]),
              f"{name} loss {run['loss']} vs {one['loss']} on one rank")
        check(run["dist"] <= KERNEL_SLACK * one["dist"],
              f"{name} gradients {run['dist']} from float32 vs "
              f"{one['dist']} on one rank")
        check(abs(run["grad_norm"] - run["full_norm"])
              <= MESH_NORM_RTOL * run["full_norm"],
              f"{name} grad_norm {run['grad_norm']} vs its gathered "
              f"gradients' {run['full_norm']}")
        # each step's gradients lie within their distance bound of
        # float32's, so their norms lie within the sum of the two bounds
        # of each other
        check(abs(run["grad_norm"] - one["grad_norm"])
              <= (1 + KERNEL_SLACK) * one["dist"] * one["grad_norm_f32"],
              f"{name} grad_norm {run['grad_norm']} vs "
              f"{one['grad_norm']} on one rank")


def mesh_trace(dev, root: Path) -> dict:
    """A train run (the head on a frozen 15-layer backbone, batch 4, two
    talks, one epoch) with runtime.profile_steps=2: its trace file under
    <run>/profile and the port's kernels among its CUDA events."""
    from wav2vecsegmenter_tpu_torch.config import Config, merge
    from wav2vecsegmenter_tpu_torch.train.loop import train

    talks, segments = write_corpus(root, 2)
    split = {"talk_list": talks, "segments_list": segments,
             "segment_length": TRAIN_WINDOW}
    config = merge(Config(), {
        "exp_name": "profiled", "batch_size": 4, "learning_rate": 2.5e-4,
        "max_epochs": 1, "update_freq": 1, "segment_length": TRAIN_WINDOW,
        "print_every_steps": 100, "save_ckpts": False, "task": SHAS_TASK,
        "data": {"train": split, "eval": split},
        "runtime": {"device": dev.type, "compute_dtype": "bfloat16",
                    "kernels": "auto", "seed": 0, "profile_steps": 2}})
    out = train(config, work_dir=root)
    files = sorted((root / "profiled" / "profile").glob("*.pt.trace.json"))
    check(len(files) == 1, f"the profiled train run wrote {len(files)} "
                           f"trace files")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    named = {k: any(k in name for name in kernels) for k in TRACE_KERNELS}
    check(all(named.values()), f"the trace lacks the port's kernels: "
                               f"{named}")
    return {"file": files[0].name, "cuda_kernels": len(kernels),
            "port_kernels": named, "micro_steps": len(out["history"]["loss"])}


def run_mesh(dev) -> dict:
    """The mesh phase (18); returns the tensor-parallel runs' launches
    (the segment run's and the LNA step's)."""
    from torch import distributed as dist

    from wav2vecsegmenter_tpu_torch.cli.common import runtime_mesh
    from wav2vecsegmenter_tpu_torch.config import Config
    from wav2vecsegmenter_tpu_torch.core import runtime

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wavs = [Path(tmp) / name for name in MESH_TALKS]
        for seed, w in enumerate(wavs):
            write_talk(w, MESH_TALKS[w.name], seed)
        # (a) world size 1 over NCCL against no group
        model = mesh_model(dev).eval()
        mesh_segment(model, wavs, dev)
        rows0, _, _ = mesh_segment(model, wavs, dev)
        steps0 = frozen_steps(model, dev)
        with env({"W2VSEG_COORDINATOR":
                  f"127.0.0.1:{runtime._free_port()}",
                  "W2VSEG_NUM_PROCESSES": "1", "W2VSEG_PROCESS_ID": "0"}):
            runtime.maybe_init_distributed("cuda")
        try:
            one = {"backend": dist.get_backend(),
                   "world": runtime.world_size()}
            check(one == {"backend": "nccl", "world": 1},
                  f"not a group of one NCCL rank: {one}")
            for conf in ({"data": 1, "model": 1}, {"data": -1, "model": 1}):
                mesh = runtime_mesh(Config({"runtime": {
                    "device": "cuda", "mesh": conf}}))
                check(mesh is None, f"a mesh of one rank from {conf}")
                rows1, _, _ = mesh_segment(model, wavs, dev, mesh=mesh)
                check(rows1 == rows0, f"the rows on {conf} differ from the "
                                      f"run without a group")
            steps1 = frozen_steps(model, dev, mesh)
            for (l0, g0), (l1, g1) in zip(steps0, steps1):
                check(torch.equal(l0, l1) and all(
                    torch.equal(a, b) for a, b in zip(g0, g1)),
                    "a frozen micro-step in the group of one differs from "
                    "the run without a group")
        finally:
            dist.destroy_process_group()
        del model, steps0, steps1
        torch.cuda.empty_cache()
        one_s = time.perf_counter() - start
        # (b) two ranks on the one card over gloo
        t0 = time.perf_counter()
        ranks = runtime.launch_ranks("chip_smoke:mesh_rank",
                                     [str(w) for w in wavs], MESH_RANKS)
        ranks_s = time.perf_counter() - t0
        windows = {"one_rank": sweep_windows(wavs),
                   "data_ranks": [sweep_windows(wavs, MESH_RANKS, r)
                                  for r in range(MESH_RANKS)]}
        reads_alone = {"one_rank": sweep_reads_alone(wavs),
                       "data_ranks": [sweep_reads_alone(wavs, MESH_RANKS, r)
                                      for r in range(MESH_RANKS)]}
        # (c) the profiled train run's trace
        t0 = time.perf_counter()
        (Path(tmp) / "train").mkdir()
        trace = mesh_trace(dev, Path(tmp) / "train")
        trace_s = time.perf_counter() - t0
    one_f32 = ranks["one_vs_f32"]
    for name in ("dp", "tp"):
        run = ranks[name]
        check(run["segments"] > 0, f"{name}: no segments")
        for q in ("mean", "p99"):
            check(run["vs_f32"][q] <= KERNEL_SLACK * one_f32[q],
                  f"{name} mesh: {q} dprob to float32 {run['vs_f32'][q]} "
                  f"vs {one_f32[q]} on one rank")
    # every rank reads through the native loader; on data=2 a rank reads
    # its rows of each batch and no other, on model=2 every window
    for name in ("dp", "tp"):
        for r, got in enumerate(ranks[name]["reads"]):
            check(got["reader_backend"] == "native",
                  f"{name} rank {r} reads through {got['reader_backend']}")
            want = (windows["data_ranks"][r] if name == "dp"
                    else windows["one_rank"])
            check(got["windows_read"] == want,
                  f"{name} rank {r} read {got['windows_read']} windows, "
                  f"its rows hold {want}")
    check(sum(windows["data_ranks"]) == windows["one_rank"]
          and max(windows["data_ranks"]) < windows["one_rank"],
          f"the data ranks' rows do not split the sweep: {windows}")
    # the data-parallel yaml: each rank's half of a batch is a change of
    # batch size, held to tests/test_packing.py's row bounds
    check(ranks["dp"]["rows_vs_one"]["beyond_bounds"] == 0,
          f"data-parallel rows vs one rank: {ranks['dp']['rows_vs_one']}")
    for name in DEFAULT_PATH + ("row_dot",):
        check(ranks["tp"]["launches"].get(name, 0) > 0,
              f"kernel {name} never launched on the tensor-parallel run")
    check_lna_runs(ranks, [name for name, _, _ in MESH_LNA_RUNS])
    lna = ranks["lna_tp"]
    launches_mesh = {k: ranks["tp"]["launches"].get(k, 0)
                     + lna["launches"].get(k, 0)
                     for k in set(ranks["tp"]["launches"])
                     | set(lna["launches"])}
    phase("mesh", reader_backend=native_reads(),
          seconds=time.perf_counter() - start,
          world1_nccl_seconds=one_s, ranks_seconds=ranks_s,
          sweep_windows=windows, sweep_read_ms_alone=reads_alone,
          trace_seconds=trace_s, world1_nccl="rows and 3 frozen "
          "micro-steps bitwise equal", backend=ranks["backend"],
          one_rank_vs_f32=one_f32,
          one_rank_read_ms_per_batch=ranks["one_read_ms_per_batch"],
          data=ranks["dp"], model=ranks["tp"],
          lna_one=ranks["lna_one"], lna_tp=lna, lna_dp=ranks["lna_dp"],
          fsdp=ranks["fsdp"], trace=trace, launches_mesh=launches_mesh)
    return launches_mesh


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    start = t0 = time.perf_counter()
    _build.library()
    ptxas = ptxas_report(_build.build_log)
    f32_attn = {k: v for k, v in ptxas.items()
                if k.split(" ")[0] in F32_ATTN_KERNELS}
    f32_gemm = {k: v for k, v in ptxas.items()
                if k.split(" ")[0] in F32_GEMM_KERNELS}
    phase("build", seconds=time.perf_counter() - t0,
          nvcc_seconds=_build.build_seconds, ptxas=ptxas,
          f32_attention_ptxas=f32_attn, f32_gemm_ptxas=f32_gemm)
    # each of the four float32 attention kernels at D = 64, 96 and 128
    check(len(f32_attn) == 3 * len(F32_ATTN_KERNELS),
          f"float32 attention kernels in the ptxas report: {f32_attn}")
    for name, n in F32_GEMM_KERNELS.items():
        check(sum(k.split(" ")[0] == name for k in f32_gemm) == n,
              f"float32 GEMM kernels in the ptxas report: {f32_gemm}")

    kernels = check_kernels(dev)
    # the bf16 conv and LayerNorm kernels (K9's too) and the float32
    # layer 0: no spills (checked after the kernel rows, so that this
    # script run on an earlier checkout still times its kernels before it
    # stops here)
    for name in CONV_KERNELS[:3] + LN_KERNELS[:1] + LN_BWD_KERNELS[:1]:
        found = [v for k, v in ptxas.items() if k.startswith(name + " ")]
        check(bool(found) and all(v.endswith("spills 0/0 bytes")
                                  for v in found),
              f"{name}: {found or 'not in the ptxas report'}")
    counts, counts_unfused, model = run_slice(dev)
    time_batch(dev, model, profile="--profile" in sys.argv)
    run_precision(dev, model)
    run_int8(dev, model)
    run_packing(dev, model)
    counts_online = run_online(dev, model)
    t_st = time.perf_counter()
    stage1 = run_stage1(dev, model)
    t_st = time.perf_counter() - t_st
    del model
    torch.cuda.empty_cache()
    counts_train, st_eval = run_train(dev, profile="--profile" in sys.argv)
    phase("st", seconds=t_st + st_eval["seconds"], stage1=stage1,
          st_eval=st_eval)
    torch.cuda.empty_cache()
    run_resume(dev)
    torch.cuda.empty_cache()
    lna = run_lna(dev)
    torch.cuda.empty_cache()
    counts_ssl = run_ssl(dev)
    torch.cuda.empty_cache()
    counts_arseg = run_arseg(dev)
    torch.cuda.empty_cache()
    counts_base = run_base(dev)
    torch.cuda.empty_cache()
    counts_base_train = run_base_train(dev)
    torch.cuda.empty_cache()
    counts_mesh = run_mesh(dev)

    def launches(name):
        # the LNA recipe's run: every kernel of the trainer's path; K2
        # runs on the unfused arm only; the output layer's kernel at
        # inference only (the slice)
        if name in TRAIN_PATH:
            return "lna", lna["launches"][name]
        if name == "row_dot":
            return "slice", counts[name]
        return "slice_unfused", counts_unfused[name]

    phase("total", seconds=time.perf_counter() - start)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches(name)[1], "launches_path": launches(name)[0],
         "launches_slice": counts.get(name, 0),
         "launches_train": counts_train.get(name, 0),
         "launches_online": counts_online.get(name, 0),
         "launches_ssl": counts_ssl.get(name, 0),
         "launches_arseg": counts_arseg.get(name, 0),
         "launches_base": counts_base.get(name, 0),
         "launches_base_train": counts_base_train.get(name, 0),
         "launches_mesh": counts_mesh.get(name, 0),
         **kernels[name],
         **({"function": lna["functions"][name]}
            if name in lna["functions"] else {})}
        for name, (src, rep) in SOURCES.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
