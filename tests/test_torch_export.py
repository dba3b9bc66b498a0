"""The serving artifact (``serving.py``'s ``export_forward``,
``save_artifact``, ``load_artifact``, ``predict_batches``) on the CPU: the
JAX package's contract (``tests/test_serving_export.py``) held against the
JAX models with the same weights (``utils/convert.py``), the fused
artifact's custom ops (``ops/export_ops.py``), a portable artifact served
by a process that imports nothing of the port, and the driver's
``--export_serving``.

Tolerance: the portable artifact's fp32 logits against the JAX model's
within ``FP32_ATOL`` (1e-4, ``tests/test_torch_bert.py``: the same math in
another library's summation order); against the port's own eager model
bit for bit (the same aten ops).
"""

import dataclasses
import json
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu.config import (
    BertConfig as JBertConfig,
    MultimodalConfig as JMultimodalConfig,
    XLNetConfig as JXLNetConfig,
)
from bert_multimodal_transformer_tpu.models import bert as jbert
from bert_multimodal_transformer_tpu.models import xlnet as jxl
from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch import serving
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    BatchIterator,
    PackedSplit,
)
from bert_multimodal_transformer_tpu_torch.models import bert as tbert
from bert_multimodal_transformer_tpu_torch.models import xlnet as txl
from bert_multimodal_transformer_tpu_torch.ops import export_ops
from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
    xlnet_params_from_flax,
)

SEQ, DV, DA = 20, 5, 7
FP32_ATOL = 1e-4
EXPORT = dict(seq_len=SEQ, visual_dim=DV, acoustic_dim=DA)


def _batch(b, seq=SEQ, vocab=128, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, seq)).astype(np.int32)
    vis = rng.randn(b, seq, DV).astype(np.float32)
    aco = rng.randn(b, seq, DA).astype(np.float32)
    mask = np.ones((b, seq), np.int32)
    mask[0, seq // 2:] = 0
    seg = np.zeros((b, seq), np.int32)
    return ids, vis, aco, mask, seg


def _jax_pair(family, num_labels=1):
    """(JAX logits function of a batch, the port's einsum model holding
    the JAX model's initialized weights)."""
    ids, vis, aco, mask, seg = _batch(2)
    if family == "bert":
        jcfg = dataclasses.replace(JBertConfig.tiny(), num_labels=num_labels)
        jmodel = jbert.MagBertForSequenceClassification(
            jcfg, JMultimodalConfig(), visual_dim=DV, acoustic_dim=DA)
        convert = params_from_flax
    else:
        jcfg = dataclasses.replace(JXLNetConfig.tiny(),
                                   num_labels=num_labels)
        jmodel = jxl.MagXLNetForSequenceClassification(
            jcfg, JMultimodalConfig(injection_index=1), visual_dim=DV,
            acoustic_dim=DA)
        convert = xlnet_params_from_flax
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), ids, vis, aco,
                                  mask, seg)["params"]
    tmodel = _port_model(family, num_labels=num_labels)
    # a JAX XLNet init without target_mapping makes no mask_emb
    missing, unexpected = tmodel.load_state_dict(
        convert(jax.device_get(params)), strict=False)
    assert not unexpected and set(missing) <= {"transformer.mask_emb"}

    @jax.jit
    def logits(ids, vis, aco, mask, seg):
        out = jmodel.apply({"params": params}, ids, vis, aco,
                           attention_mask=mask, token_type_ids=seg,
                           deterministic=True)
        return out[0] if isinstance(out, tuple) else out

    return (lambda batch: np.asarray(logits(*batch))), tmodel


@pytest.fixture(scope="module")
def bert_pair():
    return _jax_pair("bert")


@pytest.fixture(scope="module")
def bert_artifact(bert_pair, tmp_path_factory):
    """(the loaded portable artifact of ``bert_pair``'s port model, its
    path)."""
    return _roundtrip(tmp_path_factory.mktemp("bert"), bert_pair[1])


@pytest.fixture(scope="module")
def xlnet_artifact(tmp_path_factory):
    """(JAX logits, the port's model, its loaded portable artifact, the
    artifact's path)."""
    jax_logits, tmodel = _jax_pair("xlnet")
    serve, path = _roundtrip(tmp_path_factory.mktemp("xlnet"), tmodel)
    return jax_logits, tmodel, serve, path


def _port_model(family, attention_impl="einsum", fused_mag=False,
                num_labels=1, **cfg):
    mm = MultimodalConfig(injection_index=1 if family == "xlnet" else 0,
                          use_fused_kernel=fused_mag)
    base = BertConfig.tiny() if family == "bert" else XLNetConfig.tiny()
    config = dataclasses.replace(base, attention_impl=attention_impl,
                                 num_labels=num_labels, **cfg)
    cls = (tbert.MagBertForSequenceClassification if family == "bert"
           else txl.MagXLNetForSequenceClassification)
    return cls(config, mm, DV, DA, device="cpu")


def _eager(model, batch):
    ids, vis, aco, mask, seg = (torch.from_numpy(a) for a in batch)
    with torch.no_grad():
        return model(ids, vis, aco, attention_mask=mask,
                     token_type_ids=seg).numpy()


def _roundtrip(tmp_path, model, name="model.pt2", **kw):
    program = serving.export_forward(model, **EXPORT, **kw)
    path = str(tmp_path / name)
    serving.save_artifact(path, program, meta={"family": "test"})
    return serving.load_artifact(path, device="cpu"), path


@pytest.mark.parametrize("family", ["bert", "xlnet"])
def test_portable_artifact_matches_jax_any_batch(family, request):
    """export → save → load → call equals the JAX model's deterministic
    forward, and the symbolic batch serves sizes never traced: 1 (the
    partial batch), 2 and 5 from one artifact."""
    if family == "bert":
        jax_logits, tmodel = request.getfixturevalue("bert_pair")
        serve, _ = request.getfixturevalue("bert_artifact")
    else:
        jax_logits, tmodel, serve, _ = request.getfixturevalue(
            "xlnet_artifact")
    for b in (1, 2, 5):
        batch = _batch(b, seed=b)
        out = serve(*batch).numpy()
        np.testing.assert_allclose(out, jax_logits(batch), atol=FP32_ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(out, _eager(tmodel, batch))


def test_sidecar_describes_calling_convention(bert_artifact):
    path = bert_artifact[1]
    with open(path + ".json") as f:
        side = json.load(f)
    assert side["format"] == "magtorch-serving"
    assert side["platforms"] == ["cuda", "cpu"]
    assert [x["name"] for x in side["inputs"]] == [
        "input_ids", "visual", "acoustic", "attention_mask",
        "token_type_ids"]
    assert side["inputs"][0]["shape"] == ["b", str(SEQ)]
    assert side["inputs"][0]["dtype"] == "int32"
    assert side["inputs"][1]["shape"] == ["b", str(SEQ), str(DV)]
    assert side["inputs"][1]["dtype"] == "float32"
    assert side["outputs"] == [{"shape": ["b", "1"], "dtype": "float32"}]
    assert side["custom_ops"] == [] and side["family"] == "test"


def test_fused_model_exports_portable_einsum(tmp_path, bert_pair):
    """A model on the fused attention and MAG kernels exports a copy on
    the einsum path and the plain gate by default: no custom op in the
    graph, the caller's model untouched, and the same function as the
    einsum model with its weights (and as the JAX model's)."""
    jax_logits, emodel = bert_pair
    fmodel = _port_model("bert", "fused", fused_mag=True)
    fmodel.load_state_dict(emodel.state_dict())
    serve, _ = _roundtrip(tmp_path, fmodel)
    assert export_ops.ops_in(serve.program) == []
    assert all(str(n.target).startswith(("aten.", "<built-in"))
               for n in serve.program.graph.nodes
               if n.op == "call_function")
    assert fmodel.config.attention_impl == "fused"
    assert fmodel.bert.MAG.use_fused_kernel
    assert all(p.requires_grad for p in fmodel.parameters())
    batch = _batch(3, seed=3)
    out = serve(*batch).numpy()
    np.testing.assert_array_equal(out, _eager(emodel, batch))
    np.testing.assert_allclose(out, jax_logits(batch), atol=FP32_ATOL,
                               rtol=0)


def test_keep_fused_requires_cuda_only_platforms():
    with pytest.raises(ValueError, match="only run on CUDA"):
        serving.export_forward(_port_model("bert", "fused"), **EXPORT,
                               platforms=("cuda", "cpu"),
                               keep_attention_impl=True, batch_size=4)


def test_keep_fused_requires_concrete_batch():
    with pytest.raises(ValueError, match="batch_size"):
        serving.export_forward(_port_model("bert", "fused"), **EXPORT,
                               platforms=("cuda",),
                               keep_attention_impl=True)


def test_predict_batches_drops_padding(bert_pair, bert_artifact):
    """predict_batches keeps the valid rows only, as
    ``Trainer.test_epoch``."""
    model, serve = bert_pair[1], bert_artifact[0]
    rng = np.random.RandomState(9)

    def loader():
        for i, valid in enumerate((np.array([True, True]),
                                   np.array([True, False]))):
            lab = rng.randn(2, 1).astype(np.float32)
            yield _batch(2, seed=10 + i) + (lab,), valid

    preds, labels = serving.predict_batches(serve, loader())
    assert preds.shape == (3,) and labels.shape == (3,)
    np.testing.assert_array_equal(
        preds[2], _eager(model, _batch(2, seed=11)).reshape(-1)[0])


def test_fixed_batch_export_roundtrip(tmp_path, bert_pair):
    """batch_size=N gives concrete input shapes; the artifact matches the
    JAX forward at that batch and refuses another."""
    jax_logits, tmodel = bert_pair
    serve, path = _roundtrip(tmp_path, tmodel, batch_size=4)
    nodes = {n.name: n for n in serve.program.graph.nodes}
    first = nodes[serve.program.graph_signature.user_inputs[0]]
    assert tuple(first.meta["val"].shape) == (4, SEQ)
    assert serve.sidecar["inputs"][0]["shape"] == ["4", str(SEQ)]
    batch = _batch(4)
    np.testing.assert_allclose(serve(*batch).numpy(), jax_logits(batch),
                               atol=FP32_ATOL, rtol=0)
    with pytest.raises(Exception):
        serve(*_batch(5))


def test_predict_batches_classification_artifact(tmp_path):
    """A num_labels > 1 artifact's [B, C] logits: padded rows dropped, the
    class axis kept."""
    jax_logits, tmodel = _jax_pair("bert", num_labels=3)
    serve, _ = _roundtrip(tmp_path, tmodel)
    rng = np.random.RandomState(5)

    def loader():
        for i, valid in enumerate((np.array([True, True]),
                                   np.array([True, False]))):
            lab = rng.randint(0, 3, (2,)).astype(np.float32)
            yield _batch(2, seed=20 + i) + (lab,), valid

    preds, labels = serving.predict_batches(serve, loader())
    assert preds.shape == (3, 3) and labels.shape == (3,)
    np.testing.assert_allclose(preds[2], jax_logits(_batch(2, seed=21))[0],
                               atol=FP32_ATOL, rtol=0)


# (family, fused MAG gate, config options, sequence length, the ops the
# graph must call in order, the plain version the CPU op runs)
FUSED_CASES = {
    "bert": ("bert", True, {}, SEQ,
             ["mag_fwd", "attn_fwd_packed", "attn_fwd_packed"],
             tfa.attn_fwd_packed_reference),
    "bert_qkv_fusion": ("bert", False, dict(qkv_fusion=True), SEQ,
                        ["attn_fwd_qkvproj"] * 2, None),
    "bert_hb": ("bert", False, dict(max_position_embeddings=600), 600,
                ["attn_fwd_packed_hb"] * 2, tfa.attn_fwd_packed_hb_reference),
    "xlnet": ("xlnet", True, {}, SEQ,
              ["attn_fwd_rel", "mag_fwd", "attn_fwd_rel"],
              tfa.attn_fwd_rel_reference),
    "xlnet_inkernel": ("xlnet", False, dict(rel_bias_impl="inkernel"), SEQ,
                       ["attn_fwd_relik"] * 2, None),
    "xlnet_stream_fs": ("xlnet", False, dict(rel_bias_impl="stream"), 700,
                        ["attn_fwd_rel_fs"] * 2, None),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_artifact_holds_the_kernels_as_custom_ops(tmp_path, case):
    """A fused artifact traced on the CPU holds one ``magtorch`` op per
    kernel call of the forward (one attention op per layer; the fused
    gate's once) and no plain attention math; it refuses to load for the
    CPU; run there all the same, each op takes its kernel's plain version,
    and the artifact equals the eager fused model bit for bit."""
    family, fused_mag, opts, seq, ops, plain = FUSED_CASES[case]
    model = _port_model(family, "fused", fused_mag=fused_mag, **opts)
    program = serving.export_forward(
        model, seq_len=seq, visual_dim=DV, acoustic_dim=DA,
        platforms=("cuda",), keep_attention_impl=True, batch_size=2)
    assert export_ops.ops_in(program) == ops
    assert not any("softmax" in str(n.target)
                   for n in program.graph.nodes)
    if case in ("bert", "xlnet"):
        # saved and loaded (the ops module is imported here already)
        path = str(tmp_path / "fused.pt2")
        serving.save_artifact(path, program)
        with open(path + ".json") as f:
            side = json.load(f)
        assert side["platforms"] == ["cuda"]
        assert side["custom_ops"] == sorted(set(ops))
        with pytest.raises(ValueError, match="exported for"):
            serving.load_artifact(path, device="cpu")
        program = torch.export.load(path)
    batch = _batch(2, seq=seq, seed=4)
    calls = plain.calls if plain is not None else 0
    out = program.module()(*(torch.from_numpy(a) for a in batch))
    if plain is not None:
        assert plain.calls - calls == ops.count(ops[-1])
    np.testing.assert_array_equal(out.numpy(), _eager(model, batch))


def test_load_artifact_wants_the_card_by_default(bert_artifact,
                                                monkeypatch):
    """``device=None`` is the card, as ``config.resolve_device``: without
    one it raises rather than serving on the CPU unasked."""
    path = bert_artifact[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.load_artifact(path)


def test_portable_artifact_serves_without_the_package(tmp_path,
                                                     xlnet_artifact):
    """A process that imports torch and numpy alone loads the portable
    (XLNet) artifact and computes this process's logits; the port is in
    none of its modules."""
    _, _, serve, path = xlnet_artifact
    batch = _batch(3, seed=7)
    np.savez(tmp_path / "batch.npz", *batch)
    script = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import torch
        arrays = np.load({str(tmp_path / "batch.npz")!r})
        args = [torch.from_numpy(arrays[f"arr_{{i}}"]) for i in range(5)]
        program = torch.export.load({path!r})
        out = program.module()(*args)
        print(json.dumps({{
            "logits": out.tolist(),
            "port": sorted(m for m in sys.modules
                           if m.startswith("bert_multimodal"))}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["port"] == []
    np.testing.assert_array_equal(
        np.asarray(result["logits"], np.float32), serve(*batch).numpy())


def test_driver_export_serving_matches_the_predictor(tmp_path, capsys):
    """``--export_serving`` after a tiny training run writes a portable
    artifact (bf16 compute) whose predictions over a split with a padded
    last batch equal ``Predictor.predict_split``'s on the same params."""
    path = str(tmp_path / "serve.pt2")
    rc = tdriver.main(["--synthetic", "--tiny", "--device", "cpu",
                       "--n_epochs", "1", "--train_batch_size", "8",
                       "--synthetic_sizes", "16", "8", "8", "--seed", "6",
                       "--attention_impl", "fused", "--use_fused_mag",
                       "--export_serving", path])
    assert rc == 0
    assert f"Exported serving artifact to {path}" in capsys.readouterr().out
    serve = serving.load_artifact(path, device="cpu")
    assert {k: serve.sidecar[k] for k in ("family", "model", "dataset")} == {
        "family": "bert", "model": "bert-base-uncased", "dataset": "mosi"}
    assert export_ops.ops_in(serve.program) == []
    state = {k.removeprefix("model."): v
             for k, v in serve.program.state_dict.items()}
    vocab = state["bert.embeddings.word_embeddings.weight"].shape[0]
    model = tbert.MagBertForSequenceClassification(
        BertConfig.tiny(vocab), MultimodalConfig(), 47, 74, torch.bfloat16,
        device="cpu")
    model.load_state_dict(state)
    rng = np.random.RandomState(8)
    n, seq = 13, 50
    mask = (np.arange(seq)[None] < rng.randint(5, seq + 1, (n, 1))).astype(
        np.int32)
    split = PackedSplit(rng.randint(0, vocab, (n, seq)).astype(np.int32),
                        rng.randn(n, seq, 47).astype(np.float32),
                        rng.randn(n, seq, 74).astype(np.float32), mask,
                        np.zeros((n, seq), np.int32),
                        rng.randn(n).astype(np.float32))
    want = serving.Predictor(model, batch_size=8).predict_split(split)
    preds, labels = serving.predict_batches(
        serve, BatchIterator(split, 8, shuffle=False, drop_remainder=False))
    np.testing.assert_array_equal(preds, want)
    np.testing.assert_array_equal(labels, split.label_ids)


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
