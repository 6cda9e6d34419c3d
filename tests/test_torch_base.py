"""The base-model geometry (``facebook/wav2vec2-base``: the group-norm conv
stack without conv bias, the post-LN encoder) in the port against the JAX
package.

The backbone comes from a local ``config.json`` with
``"feat_extract_norm": "group"``, ``"do_stable_layer_norm": false`` and
``"conv_bias": false``, as users point ``task.model.wav2vec_model_name`` at
a downloaded snapshot; both packages read it (hidden 64 or 96, two layers,
the preset's 512-channel conv stack).  Weights go JAX ``init`` ->
``export_torch_checkpoint`` -> a strict ``load_state_dict``.  The JAX
forward runs its Pallas kernels in interpret mode (no Pallas kernel runs
in its group-norm conv stack); its CLI runs the engine's XLA path.
Bounds: 1e-5 for the conv stack alone, the port's model tolerance (2e-4,
float32) for the backbone and the SHAS logits, byte equality for the
segment CLI's yaml.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.checkpoints.torch_export import (
    export_torch_checkpoint)
from wav2vecsegmenter_tpu.models import wav2vec2 as jw2v
from wav2vecsegmenter_tpu.models.shas import SHAS as JaxSHAS
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_reference_checkpoint)
from wav2vecsegmenter_tpu_torch.cli import train as tcli
from wav2vecsegmenter_tpu_torch.models import wav2vec2 as tw2v
from wav2vecsegmenter_tpu_torch.models.shas import SHAS

from .helpers import make_speechlike_wav
from .torch_tiny import threads_per_worker  # noqa: F401

CONV_TOL = 1e-5   # float32 products in another summation order
BOUND = 2e-4      # the port's float32 model tolerance
HEAD_KW = dict(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
               n_transformer_enc_heads=1, init_dropout=0.0)


def write_base_config(root, hidden: int, heads: int):
    """A local HF model dir of the base geometry at a tiny width."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps({
        "hidden_size": hidden, "num_hidden_layers": 2,
        "num_attention_heads": heads, "intermediate_size": 2 * hidden,
        "feat_extract_norm": "group", "do_stable_layer_norm": False,
        "conv_bias": False}))
    return root


@pytest.fixture(scope="module")
def base_dirs(tmp_path_factory):
    """{hidden: model dir}: 64 (2 heads of 32) and 96 (1 head of 96)."""
    root = tmp_path_factory.mktemp("base")
    return {64: write_base_config(root / "w2v64", 64, 2),
            96: write_base_config(root / "w2v96", 96, 1)}


def _pair(model_dir, path, seed: int = 0):
    """(JAX SHAS, its params, the port's SHAS in eval mode) on the same
    weights: the JAX init exported in the full layout, loaded strictly."""
    jm = JaxSHAS(wav2vec_model_name=str(model_dir), finetune_wav2vec=True,
                 **HEAD_KW)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    export_torch_checkpoint(params, jm, path)
    model = SHAS(wav2vec_model_name=str(model_dir), **HEAD_KW)
    sd = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
    model.load_state_dict(sd, strict=True)
    return jm, params, model.eval()


@pytest.fixture(scope="module")
def pairs(base_dirs, tmp_path_factory):
    root = tmp_path_factory.mktemp("base_ckpt")
    return {h: _pair(d, root / f"ckpt{h}.pt") for h, d in base_dirs.items()}


@pytest.fixture
def jax_pallas():
    """The JAX package's Pallas kernels in interpret mode, as its own tests
    run them on the CPU."""
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        set_backend("auto")


def _inputs():
    """Three windows of 1.5 s: full, a short one zero-padded past 0.8 s,
    and a batch-padding row of zeros."""
    rng = np.random.RandomState(5)
    lengths = np.array([24000, 12800, 0], np.int32)
    audio = rng.randn(3, 24000).astype(np.float32)
    audio[np.arange(24000)[None, :] >= lengths[:, None]] = 0.0
    return audio, lengths


def test_config_json_builds_the_base_geometry(base_dirs):
    """The local config.json and the preset name both give the group-norm
    stack (layer 0's GroupNorm under HF's ``layer_norm`` name, no norm and
    no conv bias in layers 1-6) and the held, unapplied encoder.layer_norm;
    ``init_from_numpy`` gives the GroupNorm scale 1 and bias 0."""
    for name in (str(base_dirs[64]), "facebook/wav2vec2-base"):
        cfg = tw2v.config_for(name, 2)
        assert (cfg.feat_extract_norm, cfg.do_stable_layer_norm,
                cfg.conv_bias) == ("group", False, False)
        keys = set(SHAS(wav2vec_model_name=name, device="meta",
                        **HEAD_KW).state_dict())
        fe = "wav2vec_model.model.feature_extractor.conv_layers"
        assert {f"{fe}.0.layer_norm.weight", f"{fe}.0.layer_norm.bias",
                "wav2vec_model.model.encoder.layer_norm.weight"} <= keys
        assert not any(k.startswith((f"{fe}.1.layer_norm", f"{fe}.6.layer"))
                       or (k.startswith(fe) and k.endswith("conv.bias"))
                       for k in keys)
    model = SHAS(wav2vec_model_name=str(base_dirs[64]), **HEAD_KW)
    gn = model.backbone.feature_extractor.conv_layers[0].layer_norm
    assert isinstance(gn, torch.nn.GroupNorm) and gn.num_groups == 512
    with torch.no_grad():
        gn.weight.fill_(3.0)
        gn.bias.fill_(2.0)
    tw2v.init_from_numpy(model.backbone, seed=0)
    assert torch.equal(gn.weight, torch.ones(512))
    assert torch.equal(gn.bias, torch.zeros(512))


def test_feature_extractor_matches_jax_group_route(pairs):
    """The conv stack alone at float32, a short zero-padded window and a
    batch-padding row among the rows (the GroupNorm's statistics take
    every row of a window): within CONV_TOL (the products' order)."""
    _, params, model = pairs[64]
    audio, _ = _inputs()
    want = np.asarray(jw2v.feature_extractor(
        params["wav2vec"], jnp.asarray(audio), model.w2v_cfg, jnp.float32))
    with torch.no_grad():
        got = tw2v.feature_extractor(
            model.backbone.feature_extractor, torch.from_numpy(audio),
            model.w2v_cfg, torch.float32).numpy()
    assert got.shape == want.shape == (3, 74, 512)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=CONV_TOL, atol=CONV_TOL)


@pytest.mark.parametrize("norm,conv_bias", [("group", False),
                                            ("group", True),
                                            ("layer", False)])
def test_unfused_conv_stacks_match_jax(norm, conv_bias):
    """Every conv stack no conv kernel takes (their gates need a LayerNorm
    and a conv bias), at 32 channels: the base models' group-norm stack,
    with and without conv bias, and a LayerNorm stack without conv bias
    (K1 on the CPU's plain version) against the JAX package's route."""
    import dataclasses

    from wav2vecsegmenter_tpu_torch.checkpoints.convert import _wav2vec_sd

    cfg = jw2v.Wav2Vec2Config(
        hidden_size=64, num_layers=1, num_heads=1, ffn_dim=128,
        conv_dim=(32,) * 7, conv_bias=conv_bias, feat_extract_norm=norm,
        do_stable_layer_norm=norm == "layer",
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    params = jax.device_get(jw2v.init_wav2vec2_params(jax.random.PRNGKey(2),
                                                      cfg))
    model = tw2v.Wav2Vec2Model(tw2v.Wav2Vec2Config(**dataclasses.asdict(cfg)))
    model.load_state_dict(_wav2vec_sd(params, ""), strict=True)
    audio, _ = _inputs()
    want = np.asarray(jw2v.feature_extractor(params, jnp.asarray(audio), cfg,
                                             jnp.float32))
    with torch.no_grad():
        got = tw2v.feature_extractor(model.feature_extractor,
                                     torch.from_numpy(audio), model.cfg,
                                     torch.float32).numpy()
    assert got.shape == want.shape == (3, 74, 32)
    np.testing.assert_allclose(got, want, rtol=CONV_TOL, atol=CONV_TOL)


@pytest.mark.parametrize("knobs", [{}, {"residual_dtype": "float32"},
                                   {"residual_dtype": "float32",
                                    "f32_last_k": 1}])
def test_wav2vec2_forward_matches_jax(pairs, jax_pallas, knobs):
    """The post-LN backbone at float32 (the slice's 2e-4), also through the
    precision ladder's knobs (f32res, f32last1), which at float32 compute
    must leave the values where they are."""
    jm, params, model = pairs[64]
    audio, lengths = _inputs()
    jkw = {k: (jnp.float32 if k == "residual_dtype" else v)
           for k, v in knobs.items()}
    tkw = {k: (torch.float32 if k == "residual_dtype" else v)
           for k, v in knobs.items()}
    h_ref, fm_ref = jw2v.wav2vec2_forward(
        params["wav2vec"], jnp.asarray(audio), jnp.asarray(lengths),
        jm.w2v_cfg, **jkw)
    with torch.no_grad():
        h, fm = tw2v.wav2vec2_forward(model.backbone, torch.from_numpy(audio),
                                      torch.from_numpy(lengths), **tkw)
    fm, fm_ref = fm.numpy(), np.asarray(fm_ref)
    np.testing.assert_array_equal(fm, fm_ref)
    assert fm.sum(1).tolist() == [74, 39, 0]
    diff = np.abs(h.numpy() - np.asarray(h_ref))[fm]
    assert np.isfinite(h.numpy()).all()
    assert diff.max() < BOUND, f"max abs diff {diff.max()}"


def test_post_ln_cast_points_under_f32res(pairs, monkeypatch):
    """bf16 compute with a float32 residual stream: as the JAX post-LN body,
    attention and the FFN read the stream cast to bf16, each LayerNorm
    reads the float32 sum of the stream and the sub-block's output."""
    model = pairs[64][2]
    log = []
    for name, site in (("layer_norm", "ln"), ("_mha", "attn"),
                       ("_ffn", "ffn")):
        real = getattr(tw2v, name)

        def spy(*args, _real=real, _site=site, **kw):
            x = args[0] if _site == "ln" else args[1]
            log.append((_site, x.dtype))
            return _real(*args, **kw)

        monkeypatch.setattr(tw2v, name, spy)
    audio, lengths = _inputs()
    with torch.no_grad():
        h, _ = tw2v.wav2vec2_forward(model.backbone, torch.from_numpy(audio),
                                     torch.from_numpy(lengths),
                                     torch.bfloat16,
                                     residual_dtype=torch.float32)
    assert torch.isfinite(h).all()
    bf, f32 = torch.bfloat16, torch.float32
    # the feature projection's LayerNorm reads the conv stack's bf16 output
    assert log == [("ln", bf)] + [("attn", bf), ("ln", f32), ("ffn", bf),
                                  ("ln", f32)] * 2


@pytest.mark.parametrize("t_out", [75, 73])
def test_shas_logits_at_head_dim_96_match_jax(pairs, jax_pallas, t_out):
    """The SFC head at D = 96 (hidden 96, one head; K4 at the base width's
    head dim): logits within 2e-4 of the JAX SHAS on the valid frames."""
    jm, params, model = pairs[96]
    assert model.seg_model.n_heads == 1 and model.w2v_cfg.hidden_size == 96
    audio, lengths = _inputs()
    out_mask = np.arange(t_out)[None, :] < np.array([t_out, 40, 0])[:, None]
    ref = np.asarray(jm.apply(params, jnp.asarray(audio),
                              jnp.asarray(lengths), jnp.asarray(out_mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(lengths),
                    torch.from_numpy(out_mask)).numpy()
    assert got.shape == ref.shape == out_mask.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - ref)[out_mask]
    assert diff.max() < BOUND, f"max abs diff {diff.max()}"


def test_reference_and_snapshot_layouts_load(pairs, base_dirs, tmp_path,
                                             monkeypatch):
    """A reference full-layout file has no encoder.layer_norm (the
    reference's truncation replaced it with Identity): it loads, the rest
    strictly.  A head-only file takes the backbone from a local HF
    snapshot of the base model, its encoder.layer_norm kept."""
    _, _, model = pairs[64]
    full = {k: v.clone() for k, v in model.state_dict().items()}
    ln = "wav2vec_model.model.encoder.layer_norm."
    ref = {k: v for k, v in full.items() if not k.startswith(ln)}
    torch.save({"state_dict": ref}, tmp_path / "ref.pt")
    fresh = SHAS(wav2vec_model_name=str(base_dirs[64]), **HEAD_KW)
    load_reference_checkpoint(tmp_path / "ref.pt", fresh)
    for k, v in ref.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    del ref["wav2vec_model.model.encoder.layers.0.layer_norm.weight"]
    torch.save({"state_dict": ref}, tmp_path / "broken.pt")
    with pytest.raises(KeyError, match="layers.0.layer_norm.weight"):
        load_reference_checkpoint(tmp_path / "broken.pt", fresh)

    snap = tmp_path / "snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(
        (base_dirs[64] / "config.json").read_text())
    prefix = "wav2vec_model.model."
    hf = {"wav2vec2." + k[len(prefix):]: v.clone() + 0.5
          for k, v in full.items() if k.startswith(prefix)}
    hf["wav2vec2.encoder.layers.7.layer_norm.weight"] = torch.ones(64)
    torch.save(hf, snap / "pytorch_model.bin")
    head = {k[len("seg_model."):]: v for k, v in full.items()
            if k.startswith("seg_model.")}
    torch.save({"state_dict": head}, tmp_path / "head.pt")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_cache"))
    fresh = SHAS(wav2vec_model_name=str(snap), **HEAD_KW)
    load_reference_checkpoint(tmp_path / "head.pt", fresh)
    got = fresh.state_dict()
    assert torch.equal(got[ln + "weight"], full[ln + "weight"] + 0.5)
    assert torch.equal(got["seg_model.layer_norm.weight"],
                       full["seg_model.layer_norm.weight"])


def test_segment_cli_yaml_equals_jax_cli(base_dirs, tmp_path):
    """The segment CLI on a base backbone named by its config dir (a train
    config with ``task.model.wav2vec_model_name=<dir>``): rows and
    ``custom_segments.yaml`` equal the JAX CLI's, byte for byte."""
    import yaml

    from wav2vecsegmenter_tpu.cli.segment import main as jax_main
    from wav2vecsegmenter_tpu.config import compose as jcompose
    from wav2vecsegmenter_tpu.config import save_config
    from wav2vecsegmenter_tpu_torch.cli.segment import main as port_main

    talks = {"talk1.wav": 9.0, "talk2.wav": 5.3}
    (tmp_path / "wav").mkdir()
    for i, (name, secs) in enumerate(talks.items()):
        make_speechlike_wav(tmp_path / "wav" / name, duration_secs=secs,
                            seed=11 + i)
    with open(tmp_path / "orig.yaml", "w") as f:
        yaml.dump([{"duration": s, "offset": 0.0, "speaker_id": "NA",
                    "wav": n} for n, s in talks.items()], f)
    model_dir = base_dirs[64]
    _pair(model_dir, tmp_path / "ckpt.pt", seed=3)
    conf = tcli.CONF_DIR
    save_config(jcompose(conf, "train", [
        f"task.model.wav2vec_model_name={model_dir}",
        "task.model.n_transformer_enc_heads=1"]),
        tmp_path / "train_config.yaml")
    common = [f"ckpt_path={tmp_path}/ckpt.pt",
              f"config_path={tmp_path}/train_config.yaml",
              f"infer_data.wav_dir={tmp_path}/wav",
              f"infer_data.orig_seg_yaml={tmp_path}/orig.yaml",
              "inference_segment_length=4", "batch_size=3",
              "runtime.compute_dtype=float32"]
    out_jax, out_port = tmp_path / "jax", tmp_path / "port"
    rows_jax = jax_main(common + [f"output_dir={out_jax}",
                                  f"+results_path={out_jax}",
                                  "runtime.kernels=xla", "runtime.mesh.data=1"])
    rows_port = port_main(common + [f"output_dir={out_port}",
                                    f"+results_path={out_port}",
                                    "+runtime.device=cpu"])
    assert rows_port == rows_jax
    assert {r["wav"] for r in rows_port} == set(talks)
    assert ((out_port / "custom_segments.yaml").read_bytes()
            == (out_jax / "custom_segments.yaml").read_bytes())
