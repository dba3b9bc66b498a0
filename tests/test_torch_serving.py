"""The port's ``Predictor`` against the JAX package's, with the same
weights and the same seeded split, on the CPU (the JAX side on a
one-device mesh, as ``tests/test_serving.py`` runs it).

Tolerance: fp32 predictions 1e-4 abs, as for the model's logits (the same
forward in another library's summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu.config import (
    BertConfig as JBertConfig,
    MeshConfig,
    MultimodalConfig as JMultimodalConfig,
)
from bert_multimodal_transformer_tpu.data.pipeline import (
    PackedSplit as JPackedSplit,
)
from bert_multimodal_transformer_tpu.models.bert import (
    MagBertForSequenceClassification as JMagBert,
)
from bert_multimodal_transformer_tpu.parallel.mesh import make_mesh
from bert_multimodal_transformer_tpu.serving import Predictor as JPredictor
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
)
from bert_multimodal_transformer_tpu_torch.data.pipeline import PackedSplit
from bert_multimodal_transformer_tpu_torch.models.bert import (
    MagBertForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.serving import Predictor
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
)

DV, DA, S, N = 3, 4, 12, 11
ATOL = 1e-4


def _arrays(n=N, seed=0, num_labels=1):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, S + 1, n)
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    ids = (rng.randint(1, 128, (n, S)) * mask).astype(np.int32)
    vis = (rng.randn(n, S, DV) * mask[..., None]).astype(np.float32)
    ac = (rng.randn(n, S, DA) * mask[..., None]).astype(np.float32)
    segs = np.zeros((n, S), np.int32)
    if num_labels == 1:
        labels = np.round(rng.randn(n), 1).astype(np.float32)
    else:
        labels = (np.arange(n) % num_labels).astype(np.float32)
    return ids, vis, ac, mask, segs, labels


def _setup(num_labels=1, attention_impl="fused"):
    jcfg = dataclasses.replace(JBertConfig.tiny(), num_labels=num_labels,
                               attention_impl=attention_impl)
    tcfg = dataclasses.replace(BertConfig.tiny(), num_labels=num_labels,
                               attention_impl=attention_impl)
    jmodel = JMagBert(jcfg, JMultimodalConfig(1.0, 0.1), visual_dim=DV,
                      acoustic_dim=DA)
    arrays = _arrays(num_labels=num_labels)
    params = jmodel.init(jax.random.PRNGKey(0), *arrays[:4])["params"]
    tmodel = MagBertForSequenceClassification(
        tcfg, MultimodalConfig(1.0, 0.1), DV, DA, device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.device_get(params)))
    jpred = JPredictor(jmodel, params,
                       mesh=make_mesh(MeshConfig(data_parallel=1)),
                       batch_size=4)
    return jpred, tmodel, JPackedSplit(*arrays), PackedSplit(*arrays)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_predict_and_score_split_match_jax(prefetch):
    jpred, tmodel, jsplit, tsplit = _setup()
    tpred = Predictor(tmodel, batch_size=4, prefetch=prefetch)
    want = jpred.predict_split(jsplit)
    got = tpred.predict_split(tsplit)
    assert got.shape == (N,)  # the ragged final batch counted once
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the scores follow from the predictions: same metrics, same inputs
    want_s = jpred.score_split(jsplit)
    got_s = tpred.score_split(tsplit)
    assert set(got_s) == {"acc", "mae", "corr", "f_score"}
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-4)


def test_predict_requests_match_jax():
    jpred, tmodel, _, _ = _setup()
    tpred = Predictor(tmodel, batch_size=4)
    reqs = [_arrays(n=4, seed=s)[:5] for s in (1, 2, 3)]
    want = list(jpred.predict_requests(iter(reqs), in_flight=2))
    got = list(tpred.predict_requests(iter(reqs), in_flight=2))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (4,)
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
    # submit/fetch by hand, and in_flight=1, give the same answers
    handle = tpred.submit(*reqs[0])
    np.testing.assert_array_equal(tpred.fetch(handle), got[0])
    serial = list(tpred.predict_requests(iter(reqs), in_flight=1))
    for g, w in zip(serial, got):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        list(tpred.predict_requests(iter(reqs), in_flight=0))


def test_classification_head_matches_jax():
    jpred, tmodel, jsplit, tsplit = _setup(num_labels=3)
    tpred = Predictor(tmodel, batch_size=4)
    got = tpred.predict_split(tsplit)
    assert got.shape == (N, 3)
    np.testing.assert_allclose(got, jpred.predict_split(jsplit), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tpred.predict_classes(tsplit),
                                  np.argmax(got, axis=-1))
    got_s = tpred.score_split(tsplit)
    assert set(got_s) == {"acc", "f_score"}
    assert 0.0 <= got_s["acc"] <= 1.0


def test_wire_dtype_matches_jax():
    """visual/acoustic sent as bf16: lossy for an fp32 model, identically
    so on both sides (the model upcasts the rounded features)."""
    jpred, tmodel, jsplit, tsplit = _setup()
    jpred.wire_dtype = jnp.bfloat16
    tpred = Predictor(tmodel, batch_size=4, wire_dtype=torch.bfloat16)
    np.testing.assert_allclose(tpred.predict_split(tsplit),
                               jpred.predict_split(jsplit), atol=ATOL,
                               rtol=0)


def test_regression_predictor_rejects_predict_classes_and_empty_split():
    _, tmodel, _, tsplit = _setup(attention_impl="einsum")
    tpred = Predictor(tmodel, batch_size=4)
    with pytest.raises(ValueError, match="classification"):
        tpred.predict_classes(tsplit)
    empty = tsplit.take(np.arange(0))
    assert tpred.predict_split(empty).shape == (0,)


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
