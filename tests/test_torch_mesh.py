"""The port's mesh (``parallel.mesh``, ``ops.shmap``, ``train.step`` on a
mesh) against the JAX package's mesh functions on the forced host devices:
the same weights and batches; the port's ranks are spawned gloo processes
(``tests/torch_mesh.py``), 2 a case, 4 for the (2, 2) mesh.

Each step case holds the port's mesh step to the JAX package's mesh step
with the JAX mesh tests' tolerances (tests/test_train.py): the loss to
rtol 1e-5, every trained parameter after AdamW's first update to rtol
5e-2 / atol 1e-3 (Adam's first update is about lr * sign(g), so reduction
orders show), and the gradient norm, taken before any update, to rtol
1e-4.  A key bias, whose gradient is 0 in exact arithmetic (softmax is
shift-invariant), may step by up to lr on either side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.data import collate as jcollate
from wav2vecsegmenter_tpu.data import vocab as jvocab
from wav2vecsegmenter_tpu.models.shas import SHAS as JaxSHAS
from wav2vecsegmenter_tpu.parallel import mesh as jmesh
from wav2vecsegmenter_tpu.train import loss as jloss
from wav2vecsegmenter_tpu.train import step as jstep
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    state_dict_from_jax_params)
from wav2vecsegmenter_tpu_torch.data import vocab as tvocab
from wav2vecsegmenter_tpu_torch.data.collate import (collate, collate_autoreg,
                                                     out_len_for)
from wav2vecsegmenter_tpu_torch.parallel import mesh as tmesh

from .helpers import TINY_W2V
from .torch_mesh import run_ranks
from .torch_mesh_worker import build, train_steps

CFG = dataclasses.replace(TINY_W2V, apply_spec_augment=False)
NO_SPEC = {"apply_spec_augment": False}
LR, TOTAL_STEPS, POS_WEIGHT = 1e-3, 10, 0.3
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-2, 1e-3


# ----------------------------------------------------------- resolve_mesh

# tests/test_train.py::test_resolve_mesh_validates_axis_sizes's cases
MESH_CASES = [None, {"data": 1, "model": 1}, {"model": 9},
              {"data": 8, "model": 2}, {"data": 0}, {"data": -1, "model": 2},
              {"data": 2}, {"data": 2, "model": 2}]


@pytest.mark.parametrize("conf", MESH_CASES, ids=str)
def test_mesh_axes_match_jax_resolve_mesh(conf):
    """On 8 devices: the same axis sizes, or the same error."""
    assert len(jax.devices()) == 8
    try:
        mesh, n_data, n_model = jmesh.resolve_mesh(conf)
        want = ("ok", n_data, n_model)
    except ValueError as e:
        want = ("error", str(e))
    try:
        got = ("ok", *tmesh.mesh_axes(conf, 8))
    except ValueError as e:
        got = ("error", str(e))
    assert got == want


def test_resolve_mesh_of_one_rank_is_none():
    assert tmesh.resolve_mesh({"data": 1, "model": 1}, 1) == (None, 1, 1)
    assert tmesh.resolve_mesh({"data": -1}, 1) == (None, 1, 1)
    with pytest.raises(ValueError, match="process group"):
        tmesh.resolve_mesh({"data": 2}, 2)  # no group in this process


@pytest.mark.parametrize("contract", ["coordinator", "auto"])
def test_ranks_join_through_the_environment(tmp_path, contract):
    """``core.runtime.maybe_init_distributed``: W2VSEG_COORDINATOR with
    W2VSEG_NUM_PROCESSES / W2VSEG_PROCESS_ID, or torchrun's variables under
    W2VSEG_DISTRIBUTED=auto; gloo on the CPU."""
    ranks = run_ranks({"scenario": "world"}, 2, tmp_path, contract=contract)
    assert ranks == [{"rank": r, "world": 2, "backend": "gloo"}
                     for r in range(2)]
    from wav2vecsegmenter_tpu_torch.core import runtime

    assert not runtime.maybe_init_distributed("cpu")  # no group here


@pytest.mark.parametrize("device_type, local, cards, expect", [
    ("cpu", None, 0, "gloo"), ("cuda", None, 4, "nccl"),
    ("cuda", "2", 1, "gloo"), ("cuda", "4", 4, "nccl")])
def test_backend_follows_the_ranks_a_card(monkeypatch, device_type, local,
                                          cards, expect):
    """``core.runtime.backend_for``: NCCL where each of a host's ranks
    (``LOCAL_WORLD_SIZE``, else the group's 4) has a card of its own,
    gloo on the CPU and where the ranks outnumber the cards."""
    from wav2vecsegmenter_tpu_torch.core import runtime

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert runtime.backend_for(device_type, 4) == expect


def test_full_tensor_gathers_uneven_fsdp_shards(tmp_path):
    """``parallel.mesh.full_tensor`` of an FSDP-sharded tensor (a plain
    all_gather of padded shards) equals the whole tensor and DTensor's
    ``full_tensor``, where the ranks do not divide dim 0 too (exact)."""
    rows = (1, 3, 4, 5)
    for out in run_ranks({"scenario": "gather_shards", "rows": rows}, 2,
                         tmp_path):
        for r in rows:
            whole, gathered, reference = out[r]
            assert torch.equal(gathered, whole)
            assert torch.equal(reference, whole)


def test_launch_ranks_returns_rank0_and_fails_with_a_rank():
    """``launch_ranks`` runs its entry on n ranks and returns rank 0's
    result; a rank that fails fails the call."""
    from wav2vecsegmenter_tpu_torch.core.runtime import launch_ranks

    assert launch_ranks("json:dumps", ["x", "y"], 2) == '["x", "y"]'
    with pytest.raises(RuntimeError, match="failed on its ranks"):
        launch_ranks("json:no_such_function", [], 2)


# ------------------------------------------------------- the split's rule

def _owner_tree(tree, shardings, n: int):
    """Each leaf as an array of the model rank that holds each element
    (-1: replicated), from the JAX shardings."""
    def one(leaf, sh):
        owner = np.full(np.shape(leaf), -1.0, np.float32)
        for ax, name in enumerate(sh.spec):
            if name == "model":
                size = leaf.shape[ax] // n
                idx = np.arange(leaf.shape[ax]) // size
                shape = [1] * leaf.ndim
                shape[ax] = -1
                owner = np.broadcast_to(idx.reshape(shape),
                                        leaf.shape).astype(np.float32)
        return owner

    return jax.tree.map(one, tree, shardings)


def _port_owner(name: str, shape, n: int) -> torch.Tensor:
    spec = tmesh.tp_spec(name, shape, n)
    if spec is None:
        return torch.full(shape, -1.0)
    dim, sections = spec
    idx = (torch.arange(shape[dim]) % (shape[dim] // sections)) \
        // (shape[dim] // sections // n)
    view = [1] * len(shape)
    view[dim] = -1
    return idx.view(view).expand(shape).float()


@pytest.mark.parametrize("kind,n", [("shas", 2), ("shas96", 3),
                                    ("arseg", 2)])
def test_split_matches_jax_param_shardings(kind, n):
    """The port's rule (``tp_spec`` on the reference state_dict names)
    assigns every element of every parameter to the model rank that JAX
    ``param_shardings`` assigns it to; with 3 model ranks the tiny widths
    (64) do not divide and stay replicated while an FFN of 96 splits."""
    from .test_autoreg import tiny_autoreg
    from .helpers import tiny_shas

    if kind == "arseg":
        jm = tiny_autoreg()
        tm = build("arseg", {}, {})
    else:
        jm = tiny_shas()
        cfg = {}
        if kind == "shas96":
            cfg = {"ffn_dim": 96}
            jm.w2v_cfg = dataclasses.replace(TINY_W2V, ffn_dim=96)
        tm = build("shas", cfg, {})
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    mesh = jmesh.make_mesh(1, n)
    owners = _owner_tree(params, jmesh.param_shardings(mesh, params), n)
    want = state_dict_from_jax_params(owners, tm)
    split = 0
    for name, value in tm.state_dict().items():
        got = _port_owner(name, tuple(value.shape), n)
        torch.testing.assert_close(got, want[name].float(), rtol=0, atol=0,
                                   msg=name)
        split += int((got >= 0).any())
    assert split >= {"shas": 20, "shas96": 4, "arseg": 30}[kind]


# ------------------------------------------------------------ mesh steps

def _frame_batches(rows: int, n: int = 1, seed: int = 1):
    """n device-normalize batches of ``rows`` windows with targets (the
    last row a padding row): (port batches, JAX batches)."""
    rng = np.random.RandomState(seed)
    port, jx = [], []
    for _ in range(n):
        examples = []
        for i in range(rows - 1):
            length = (16000, 11000, 9000)[i % 3]
            n_out = out_len_for(length)
            target = np.zeros(n_out, np.float32)
            start = rng.randint(0, n_out // 2)
            target[start:start + n_out // 3] = 1.0
            examples.append(((rng.randn(length) * 0.1).astype(np.float32),
                             target, 0, n_out))
        args = (examples, rows, 16000, out_len_for(16000))
        b = collate(*args, device_normalize=True)
        port.append(b)
        jx.append({"audio": b.audio, "in_lengths": b.in_lengths,
                   "target": b.target, "out_mask": b.out_mask,
                   "included": b.included,
                   "norm_length": np.int32(b.norm_length),
                   "pos_weight": np.float32(POS_WEIGHT)})
    return port, jx


def _jax_mesh_step(jm, params, loss_fn, tag, batches, mesh, shard: bool,
                   fsdp: bool = False, **kw):
    opt = jstep.make_optimizer(LR, TOTAL_STEPS, 1, jm.trainable_mask(params))
    state = jstep.init_train_state(jm, opt, jax.random.PRNGKey(1),
                                   jax.tree.map(jnp.asarray, params))
    st_sh = None
    if shard:
        st_sh = jmesh.state_shardings(mesh, state, fsdp=fsdp)
        state = jax.device_put(state, st_sh)
    step = jstep.make_train_step(jm, loss_fn, tag, 0, opt, mesh=mesh,
                                 state_shardings=st_sh, **kw)
    out = []
    for i, b in enumerate(batches):
        state, m = step(state, b, jax.random.PRNGKey(i))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, jax.device_get(state.params)


def _check(ranks, want, jparams, tm, gnorm_rtol=GNORM_RTOL):
    """Every rank's losses, grad norms and whole trained parameters
    against the JAX mesh step's."""
    ref = state_dict_from_jax_params(jparams, tm)
    h = CFG.hidden_size
    for r in ranks:
        for (gl, gn), (wl, wn) in zip(zip(r["loss"], r["grad_norm"]), want):
            np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(gn, wn, rtol=gnorm_rtol)
        assert r["params"], "nothing trained"
        for key, value in r["params"].items():
            want_v = ref[key]
            diff = (value - want_v).abs()
            if key.endswith("in_proj_bias"):
                assert (diff[h:2 * h] <= 2 * LR).all(), key
                diff[h:2 * h] = 0
            elif key.endswith("k_proj.bias"):
                assert (diff <= 2 * LR).all(), key
                diff[:] = 0
            bound = PARAM_ATOL + PARAM_RTOL * want_v.abs()
            assert (diff <= bound).all(), (key, diff.max().item())
    for key in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][key],
                           ranks[-1]["params"][key]), key


# (name, JAX mesh, port mesh, finetune_wav2vec)
FRAME_MESHES = [("data", (2, 1), {"data": 2}, False),
                ("model", (1, 2), {"data": 1, "model": 2}, True),
                ("data_model", (2, 2), {"data": 2, "model": 2}, True),
                ("fsdp", (2, 1), {"data": 2, "fsdp": True}, True)]


@pytest.mark.parametrize("name,jshape,conf,finetune", FRAME_MESHES,
                         ids=[m[0] for m in FRAME_MESHES])
def test_frame_step_on_mesh_matches_jax(name, jshape, conf, finetune,
                                        tmp_path, monkeypatch):
    """The bce frame step of the tiny SHAS (the backbone fine-tuned where a
    model axis or FSDP splits it) on a data, tensor, (2, 2) and FSDP mesh:
    the port's ranks against the JAX mesh step (tests/test_train.py's
    test_{data,tensor}_parallel_train_step_on_mesh and
    test_fsdp_train_step_on_mesh, whose FSDP floor is lowered the same
    way), two micro-steps on a global batch of 4 rows."""
    monkeypatch.setattr(jmesh, "_FSDP_MIN_ELEMS", 1024)
    jm = JaxSHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=4, init_dropout=0.0,
                 finetune_wav2vec=finetune)
    jm.w2v_cfg, jm.d_model, jm.keep_layers = CFG, CFG.hidden_size, 2
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    batches, jbatches = _frame_batches(4, 2)
    mesh = jmesh.make_mesh(*jshape)
    kw = dict(device_normalize=True, dynamic_pos_weight=True)
    want, jparams = _jax_mesh_step(
        jm, params, jloss.BCEWithLogitsLoss(None), "bce", jbatches, mesh,
        shard=name != "data", fsdp=name == "fsdp", **kw)
    if name == "data_model":
        # the JAX (2, 2) step reports a grad_norm 8.4% above its one-device
        # step's and every other mesh's (ROADMAP C23): the norm is held to
        # the one-device JAX step's, the loss and parameters to the mesh's
        one, _ = _jax_mesh_step(jm, params, jloss.BCEWithLogitsLoss(None),
                                "bce", jbatches, None, shard=False, **kw)
        want = [(loss, norm) for (loss, _), (_, norm) in zip(want, one)]
    kw = {"finetune_wav2vec": finetune}
    tm = build("shas", NO_SPEC, kw)
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    job = dict(scenario="train_steps", kind="shas", cfg=NO_SPEC,
               model_kw=kw, state_dict=tm.state_dict(), lr=LR,
               total_steps=TOTAL_STEPS, loss="bce", batches=batches,
               pos_weight=POS_WEIGHT, mesh=conf)
    n = jshape[0] * jshape[1]
    ranks = run_ranks(job, n, tmp_path)
    _check(ranks, want, jparams, tm)
    if name != "data":  # the ranks really held parts
        shapes = ranks[0]["local_shapes"]
        full = {k: tuple(v.shape) for k, v in ranks[0]["params"].items()}
        assert any(shapes[k] != full[k] for k in shapes)


# ctc: three transcripts (one longer than its row's conv frames, one
# empty) and a padding row: rank 0 holds 2 included rows, rank 1 one
TRANSCRIPTS = ["HELLO WORLD", "", "ABCDEFGHIJKLMNOPQRST"]
AUDIO_LEN = 161600


def test_ctc_step_on_mesh_matches_jax(tmp_path):
    """The ctc step (SHASWithSSL, backbone fine-tuned) on 2 data ranks that
    hold different counts of included rows and labels: the mean over the
    global batch's included rows, as the JAX mesh step takes it."""
    from .torch_tiny import jax_tiny_ssl, ssl_params

    vocab = tvocab.UppercasedCharVocabulary()
    jv = jvocab.UppercasedCharVocabulary()
    jm = jax_tiny_ssl(CFG, finetune_wav2vec=True)
    params = ssl_params(jm)
    rng = np.random.RandomState(1)
    examples = []
    for length in (AUDIO_LEN, 11000, 3000):
        n_out = out_len_for(length)
        examples.append(((rng.randn(length) * 0.1).astype(np.float32),
                         np.zeros(n_out, np.float32), 0, n_out))
    args = (examples, 4, AUDIO_LEN, out_len_for(AUDIO_LEN),
            vocab.pad_token_id)
    b = collate(*args, device_normalize=True, transcripts=TRANSCRIPTS,
                ctc_vocab=vocab)
    jb = jcollate.collate(*args, device_normalize=True,
                          transcripts=TRANSCRIPTS, ctc_vocab=jv)
    assert b.included[:2].sum() == 2 and b.included[2:].sum() == 1
    loss_fn, _, _ = jloss.build_loss(
        {"_target_": "torch.nn.CTCLoss", "tag": "ctc"}, None, jv)
    jbatch = {"audio": jb.audio, "in_lengths": jb.in_lengths,
              "target": jb.target, "out_mask": jb.out_mask,
              "included": jb.included, "tokens": jb.tokens,
              "norm_length": np.int32(jb.norm_length)}
    want, jparams = _jax_mesh_step(jm, params, loss_fn, "ctc", [jbatch],
                                   jmesh.make_mesh(2), shard=False,
                                   vocab=jv, device_normalize=True)
    kw = {"finetune_wav2vec": True}
    tm = build("ssl", NO_SPEC, kw)
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    job = dict(scenario="train_steps", kind="ssl", cfg=NO_SPEC, model_kw=kw,
               state_dict=tm.state_dict(), lr=LR, total_steps=TOTAL_STEPS,
               loss="ctc", vocab="char", batches=[b], mesh={"data": 2})
    ranks = run_ranks(job, 2, tmp_path)
    # the gradient norm: 2e-4 from the JAX package's float32 CTC gradient
    # (the port's recursions run in float64, train/loss.CTCLoss), and to
    # 1e-5 the port's own one-rank step on the global batch
    _check(ranks, want, jparams, tm, gnorm_rtol=5e-4)
    one = train_steps({**job, "mesh": {"data": 1}})
    np.testing.assert_allclose(ranks[0]["grad_norm"], one["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)


def test_arseg_step_with_pos_weight_on_mesh_matches_jax(tmp_path,
                                                         monkeypatch):
    """The autoregressive step (cross-entropy summed over every position)
    on 2 data ranks with the loop's dynamic ``pos_weight`` passed in (JAX
    tests/test_train.py::test_autoreg_step_with_dynamic_pos_weight_on_mesh),
    decoder dropout off on both sides."""
    from wav2vecsegmenter_tpu.models import autoreg as jautoreg

    from .torch_tiny import autoreg_params, jax_tiny_autoreg

    monkeypatch.setattr(jautoreg, "_LAYER_DROPOUT", 0.0)
    vocab = jvocab.BaseVocabulary()
    jm = jax_tiny_autoreg(CFG)
    params = autoreg_params(jm)
    rng = np.random.RandomState(2)
    examples = []
    for i in range(4):
        wav = rng.randn(16000).astype(np.float32) * 0.1
        tgt = np.zeros(48, np.float32)
        tgt[:24 + i] = 1.0
        examples.append((wav, tgt, i * 50, i * 50 + 48))
    b = collate_autoreg(examples, 4, 16000, 50, vocab.pad_token_id,
                        vocab.sep_token_id)
    jb = {f: getattr(b, f) for f in ("audio", "in_lengths", "in_target",
                                     "out_target", "src_mask", "tgt_mask")}
    jb["pos_weight"] = np.float32(0.8)
    loss_fn = jloss.CrossEntropyLoss(ignore_index=vocab.pad_token_id)
    want, jparams = _jax_mesh_step(jm, params, loss_fn, "ce", [jb],
                                   jmesh.make_mesh(2), shard=False,
                                   vocab=vocab, autoregression=True,
                                   dynamic_pos_weight=True)
    tm = build("arseg", NO_SPEC, {})
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    job = dict(scenario="train_steps", kind="arseg", cfg=NO_SPEC,
               state_dict=tm.state_dict(), lr=LR, total_steps=TOTAL_STEPS,
               loss="ce", ignore_index=vocab.pad_token_id, batches=[b],
               pos_weight=0.8, mesh={"data": 2}, layer_dropout=0.0)
    _check(run_ranks(job, 2, tmp_path), want, jparams, tm)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp_fsdp"])
def test_mesh_step_draws_the_global_batch_masks(tmp_path, fsdp):
    """With SpecAugment and dropout on (hidden 0.1, activation 0.1 inside a
    split FFN), a (2, 2) mesh step, and one whose split model is also
    FSDP-sharded over 'data', equals the one-rank step on the global
    batch: each rank draws the global batch's masks and takes its rows and
    columns (``ops.shmap.rand_rows``).  Same inputs, same generator seed;
    the losses to rtol 1e-5, the parameters to the JAX mesh tests' bounds,
    and every rank's parameters equal."""
    cfg = {"hidden_dropout": 0.1, "activation_dropout": 0.1,
           "mask_time_prob": 0.3}
    kw = {"finetune_wav2vec": True}
    tm = build("shas", cfg, kw)
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy

    init_from_numpy(tm, 0)
    batches, _ = _frame_batches(4, 1)
    job = dict(scenario="train_steps", kind="shas", cfg=cfg, model_kw=kw,
               state_dict=tm.state_dict(), lr=LR, total_steps=TOTAL_STEPS,
               loss="bce", batches=batches, pos_weight=POS_WEIGHT, seed=5)
    single = train_steps({**job, "mesh": {"data": 1}})
    ranks = run_ranks({**job, "mesh": {"data": 2, "model": 2,
                                       "fsdp": fsdp}}, 4, tmp_path / "mesh")
    for r in ranks:
        np.testing.assert_allclose(r["loss"], single["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], single["grad_norm"],
                                   rtol=1e-4)
        for key, value in r["params"].items():
            want = single["params"][key]
            bound = PARAM_ATOL + PARAM_RTOL * want.abs()
            assert ((value - want).abs() <= bound).all(), key


def test_arseg_decode_on_a_model_axis_equals_one_rank(tmp_path):
    """The autoregressive segmenter split over 2 model ranks (its encoder,
    causal and cross attentions and FFNs by the rule): the KV-cached greedy
    decode and the teacher-forced forward equal the one-rank model's
    (float32, rtol 1e-5 / atol 1e-5: only summation orders change; the
    decoded tokens equal)."""
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy

    from .torch_mesh_worker import decode

    tm = build("arseg", NO_SPEC, {})
    init_from_numpy(tm, 0)
    rng = np.random.RandomState(4)
    examples = [(rng.randn(8000).astype(np.float32) * 0.1,
                 (np.arange(24) < 10 + i).astype(np.float32), 0, 24)
                for i in range(3)]
    b = collate_autoreg(examples, 3, 8000, 25, 2, 3)
    job = dict(scenario="decode", cfg=NO_SPEC, state_dict=tm.state_dict(),
               batch=b)
    one = decode({**job, "mesh": {"data": 1}})
    for r in run_ranks({**job, "mesh": {"data": 1, "model": 2}}, 2,
                       tmp_path):
        assert torch.equal(r["tokens"], one["tokens"])
        for key in ("probs", "logits", "forced"):
            torch.testing.assert_close(r[key], one[key], rtol=1e-5,
                                       atol=1e-5)
