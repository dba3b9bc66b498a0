"""The port's HF import and export (``utils/convert.py``,
``utils/pretrained.py``) against the JAX package's, on the CPU.

Each HF checkpoint is a randomly initialised ``transformers`` model saved
in-test (as ``tests/test_pretrained.py`` builds them), as a torch
``pytorch_model.bin`` or a ``model.safetensors``. The port's import must
equal JAX's ``load_pretrained_into_params`` followed by
``params_from_flax`` / ``xlnet_params_from_flax`` array for array; with
the JAX model's fresh MAG and head carried across, the two packages' fp32
logits agree within 1e-5 at dropout 0 (two layers of the same math in
another summation order; the logits here are ~1e-2). The export must
equal JAX's, key for key and exactly.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
# transformers would import TensorFlow too (~15 s here), which no test uses
os.environ.setdefault("USE_TF", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402
from safetensors.torch import save_file  # noqa: E402

from bert_multimodal_transformer_tpu.config import (  # noqa: E402
    BertConfig as JBertConfig,
    MultimodalConfig as JMultimodalConfig,
    XLNetConfig as JXLNetConfig,
)
from bert_multimodal_transformer_tpu.utils import (  # noqa: E402
    convert as jconvert,
)
from bert_multimodal_transformer_tpu.utils import (  # noqa: E402
    pretrained as jpretrained,
)
from bert_multimodal_transformer_tpu_torch import driver as tdriver  # noqa
from bert_multimodal_transformer_tpu_torch.config import (  # noqa: E402
    BertConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.data import (  # noqa: E402
    synthetic as tsyn,
)
from bert_multimodal_transformer_tpu_torch.data import (  # noqa: E402
    tokenization as ttok,
)
from bert_multimodal_transformer_tpu_torch.utils import (  # noqa: E402
    convert as tconvert,
)
from bert_multimodal_transformer_tpu_torch.utils import (  # noqa: E402
    pretrained as tpretrained,
)

V, S, B = 64, 12, 3
DV, DA = 3, 5
LOGITS_ATOL = 1e-5
GEOMETRY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, max_position_embeddings=64)
XGEOMETRY = dict(d_model=32, n_layer=2, n_head=2, d_inner=64)


def _hf_bert(vocab=V, seed=0, **kw):
    geometry = {**GEOMETRY, **kw}
    cfg = transformers.BertConfig(vocab_size=vocab,
                                  attn_implementation="eager", **geometry)
    torch.manual_seed(seed)
    return transformers.BertModel(cfg).eval(), cfg


def _hf_xlnet(seed=2):
    cfg = transformers.XLNetConfig(vocab_size=V, **XGEOMETRY)
    torch.manual_seed(seed)
    return transformers.XLNetModel(cfg).eval(), cfg


def _save(tmp_path, name, hf_model, fmt, config=None):
    """``hf_model``'s state dict in ``tmp_path/name/`` as ``fmt`` ("bin"
    or "safetensors"), with its ``config.json`` when given."""
    d = tmp_path / name
    d.mkdir()
    sd = {k: v.contiguous() for k, v in hf_model.state_dict().items()}
    if fmt == "bin":
        torch.save(sd, d / "pytorch_model.bin")
    else:
        save_file(sd, str(d / "model.safetensors"))
    if config is not None:
        (d / "config.json").write_text(config.to_json_string())
    return str(d)


def _inputs(vocab=V, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    vis = rng.randn(B, S, DV).astype(np.float32)
    ac = rng.randn(B, S, DA).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, 7:] = 0
    return ids, vis, ac, mask


def _carry_fresh(model, want):
    """The JAX model's fresh MAG and head into the port's model."""
    fresh = {k: v for k, v in want.items()
             if ".MAG." in k or k.startswith(("classifier.",
                                              "sequence_summary.",
                                              "logits_proj."))}
    missing, unexpected = model.load_state_dict(fresh, strict=False)
    assert not unexpected


def _assert_state_equal(got, want, keys):
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


def _port_logits(model, ids, vis, ac, mask):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in (ids, vis, ac)),
                     attention_mask=torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("fmt,via_config_json",
                         [("bin", False), ("safetensors", True)])
def test_bert_import_matches_jax(tmp_path, fmt, via_config_json):
    """The encoder from the HF file equals JAX's import converted, array
    for array; the MAG and classifier stay fresh; with JAX's fresh ones
    carried across the logits agree. ``via_config_json``: no config is
    passed, the file's config.json gives the geometry."""
    hf, hf_cfg = _hf_bert()
    path = _save(tmp_path, "bert", hf, fmt, hf_cfg)
    kw = {} if via_config_json else dict(
        config=JBertConfig(vocab_size=V, **GEOMETRY))
    jmodel, jparams = jpretrained.bert_from_pretrained(
        path, JMultimodalConfig(beta_shift=1.0, dropout_prob=0.0),
        visual_dim=DV, acoustic_dim=DA, num_labels=1, max_seq_length=S,
        **kw)
    tkw = {} if via_config_json else dict(
        config=BertConfig(vocab_size=V, **GEOMETRY))
    model = tpretrained.bert_from_pretrained(
        path, MultimodalConfig(beta_shift=1.0, dropout_prob=0.0),
        visual_dim=DV, acoustic_dim=DA, device="cpu", **tkw)
    assert model.config.hidden_size == 32 and model.config.vocab_size == V
    want = tconvert.params_from_flax(jparams)
    got = model.state_dict()
    assert set(got) == set(want)
    encoder = [k for k in want if ".MAG." not in k
               and not k.startswith("classifier.")]
    _assert_state_equal(got, want, encoder)
    hf_sd = hf.state_dict()
    np.testing.assert_array_equal(
        got["bert.encoder.layer.1.attention.qkv.weight"][32:64].numpy(),
        hf_sd["encoder.layer.1.attention.self.key.weight"].numpy())
    # MAG and the classifier keep the port's own fresh draw
    assert not torch.equal(got["bert.MAG.w_v"], want["bert.MAG.w_v"])

    _carry_fresh(model, want)
    _assert_state_equal(model.state_dict(), want, want)
    ids, vis, ac, mask = _inputs()
    jl = np.asarray(jmodel.apply({"params": jparams}, ids, vis, ac, mask))
    tl = _port_logits(model, ids, vis, ac, mask)
    assert tl.shape == jl.shape == (B, 1)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGITS_ATOL)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_xlnet_import_matches_jax(tmp_path, fmt):
    """The same for MAG-XLNet: the flat q/k/v/o/r, the biases, seg_embed
    and the FFN against JAX's import converted; ``mask_emb`` (absent from
    a JAX tree initialised without target_mapping) straight from HF."""
    hf, _ = _hf_xlnet()
    path = _save(tmp_path, "xlnet", hf, fmt)
    mm = dict(beta_shift=1.0, dropout_prob=0.0, injection_index=1)
    jmodel, jparams = jpretrained.xlnet_from_pretrained(
        path, JMultimodalConfig(**mm), visual_dim=DV, acoustic_dim=DA,
        config=JXLNetConfig(vocab_size=V, **XGEOMETRY), num_labels=1,
        max_seq_length=S)
    model = tpretrained.xlnet_from_pretrained(
        path, MultimodalConfig(**mm), visual_dim=DV, acoustic_dim=DA,
        config=XLNetConfig(vocab_size=V, **XGEOMETRY), device="cpu")
    want = tconvert.xlnet_params_from_flax(jparams)
    got = model.state_dict()
    assert set(got) == set(want) | {"transformer.mask_emb"}
    hf_sd = hf.state_dict()
    np.testing.assert_array_equal(got["transformer.mask_emb"].numpy(),
                                  hf_sd["mask_emb"].numpy())
    encoder = [k for k in want if ".MAG." not in k
               and not k.startswith(("sequence_summary.", "logits_proj."))]
    _assert_state_equal(got, want, encoder)
    np.testing.assert_array_equal(
        got["transformer.layer.0.rel_attn.q"].numpy(),
        hf_sd["layer.0.rel_attn.q"].reshape(32, 32).numpy())

    _carry_fresh(model, want)
    _assert_state_equal(model.state_dict(), want, want)
    ids, vis, ac, mask = _inputs()
    jl = np.asarray(jmodel.apply({"params": jparams}, ids, vis, ac, mask))
    tl = _port_logits(model, ids, vis, ac, mask)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGITS_ATOL)


def test_head_loads_when_both_sides_have_it(tmp_path):
    """An HF ``XLNetForSequenceClassification`` file carries its
    ``sequence_summary`` and ``logits_proj`` (and the ``transformer.``
    prefix): the port loads them, as JAX does."""
    cfg = transformers.XLNetConfig(vocab_size=V, num_labels=1, **XGEOMETRY)
    torch.manual_seed(4)
    hf = transformers.XLNetForSequenceClassification(cfg).eval()
    path = _save(tmp_path, "xlnet_cls", hf, "bin")
    model = tpretrained.xlnet_from_pretrained(
        path, MultimodalConfig(injection_index=1), visual_dim=DV,
        acoustic_dim=DA, config=XLNetConfig(vocab_size=V, **XGEOMETRY),
        device="cpu")
    got, hf_sd = model.state_dict(), hf.state_dict()
    for k in ("sequence_summary.summary.weight", "logits_proj.bias",
              "transformer.layer.1.ff.layer_2.weight"):
        np.testing.assert_array_equal(got[k].numpy(), hf_sd[k].numpy())


def test_short_position_table_fails_loudly(tmp_path):
    """A [64, D] position table into a model whose table is longer (the
    driver extends it past --max_seq_length) raises, naming the param,
    and loads nothing."""
    hf, _ = _hf_bert()
    path = _save(tmp_path, "bert", hf, "bin")
    cfg = BertConfig(vocab_size=V, **{**GEOMETRY,
                                      "max_position_embeddings": 96})
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )

    model = MagBertForSequenceClassification(cfg, MultimodalConfig(), DV,
                                             DA, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="position_embeddings.*96"):
        tconvert.load_pretrained_into_model(model, path, "bert")
    _assert_state_equal(model.state_dict(), before, before)


def test_missing_checkpoint_raises_like_jax(tmp_path):
    """A missing file and a directory without weights raise
    FileNotFoundError with the JAX loader's messages."""
    for path in (str(tmp_path / "nope.bin"), str(tmp_path)):
        with pytest.raises(FileNotFoundError) as jerr:
            jconvert.load_torch_state_dict(path)
        with pytest.raises(FileNotFoundError) as terr:
            tconvert.load_torch_state_dict(path)
        assert str(terr.value) == str(jerr.value)


def test_bert_export_matches_jax(tmp_path):
    """JAX's export of JAX params = the port's export of the same params
    converted, key for key and bit for bit; and HF → port → HF gives the
    HF state dict back exactly."""
    hf, hf_cfg = _hf_bert()
    path = _save(tmp_path, "bert", hf, "bin", hf_cfg)
    _, jparams = jpretrained.bert_from_pretrained(
        path, JMultimodalConfig(), visual_dim=DV, acoustic_dim=DA,
        max_seq_length=S)
    want = jconvert.export_bert_state_dict(jparams, 2)
    got = tconvert.export_bert_state_dict(
        tconvert.params_from_flax(jparams), 2)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    model = tpretrained.bert_from_pretrained(
        path, MultimodalConfig(), visual_dim=DV, acoustic_dim=DA,
        device="cpu")
    back = tconvert.export_bert_state_dict(model.state_dict(), 2)
    hf_sd = hf.state_dict()
    assert set(back) == set(hf_sd)
    for k, v in back.items():
        assert torch.equal(v, hf_sd[k]), k
        assert v.untyped_storage().nbytes() == v.numel() * 4, k


def test_xlnet_export_matches_jax(tmp_path):
    hf, _ = _hf_xlnet()
    path = _save(tmp_path, "xlnet", hf, "safetensors")
    _, jparams = jpretrained.xlnet_from_pretrained(
        path, JMultimodalConfig(injection_index=1), visual_dim=DV,
        acoustic_dim=DA, config=JXLNetConfig(vocab_size=V, **XGEOMETRY),
        max_seq_length=S)
    want = jconvert.export_xlnet_state_dict(jparams, 2)
    got = tconvert.export_xlnet_state_dict(
        tconvert.xlnet_params_from_flax(jparams), 2)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    model = tpretrained.xlnet_from_pretrained(
        path, MultimodalConfig(injection_index=1), visual_dim=DV,
        acoustic_dim=DA, config=XLNetConfig(vocab_size=V, **XGEOMETRY),
        device="cpu")
    back = tconvert.export_xlnet_state_dict(model.state_dict(), 2)
    hf_sd = hf.state_dict()
    assert set(back) == set(hf_sd)
    for k, v in back.items():
        assert torch.equal(v, hf_sd[k]), k


def _driver(argv):
    vocab = ttok.WordPieceTokenizer.from_wordlist(
        tsyn.vocabulary()).vocab_size
    return vocab, tdriver.main([
        "--model", "bert-base-uncased", "--dataset", "mosi", "--synthetic",
        "--tiny", "--train_batch_size", "8", "--dev_batch_size", "8",
        "--test_batch_size", "8", "--synthetic_sizes", "16", "8", "8",
        "--seed", "4", "--compute_dtype", "float32", "--device", "cpu",
        *argv])


def test_driver_export_then_warm_start(tmp_path, monkeypatch, capsys):
    """``--export_hf`` after a short run, then a fresh run warm-started
    from that file (``--n_epochs 0``: no step) exports it back bit for
    bit, through .safetensors and .bin. An HF checkpoint's shorter
    position table under a longer ``--max_seq_length`` raises."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    first = str(tmp_path / "first.safetensors")
    vocab, rc = _driver(["--n_epochs", "1", "--export_hf", first])
    assert rc == 0 and f"Exported HF-format weights to {first}" in \
        capsys.readouterr().out
    again = str(tmp_path / "again.bin")
    assert _driver(["--n_epochs", "0", "--pretrained_checkpoint", first,
                    "--export_hf", again])[1] == 0
    a = tconvert.load_torch_state_dict(first)
    b = tconvert.load_torch_state_dict(again)
    assert set(a) == set(b) and len(a) == 5 + 2 * 16 + 2
    for k in a:
        assert torch.equal(a[k], b[k]), k

    hf, _ = _hf_bert(vocab=vocab)
    path = _save(tmp_path, "hf", hf, "bin")
    with pytest.raises(ValueError, match="position_embeddings"):
        _driver(["--n_epochs", "1", "--max_seq_length", "80",
                 "--pretrained_checkpoint", path])


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes: the fastest for
    them, and it keeps the module from competing with the parallel test
    workers for the host's cores (as ``tests/test_torch_resume.py``)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
