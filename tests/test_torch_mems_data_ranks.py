"""XLNet's memory over data ranks: the port's ``Trainer(mesh=, mem_len=)``
and ``Predictor(mesh=, mem_len=)`` on two CPU data ranks over gloo
(spawned under a timeout of their own, in the background while JAX
compiles) against the JAX ``Trainer`` and ``Predictor`` with ``mem_len``
on a two-device data mesh, from the same weights and seeded batches,
every dropout 0, fp32.

The trainer runs grad_accum 2, so each rank's micro-batches are its share
of every micro-batch and its memory [B/(2·2), mem_len, D] a layer chains
through them: two steps, then the ragged tail's masked step, each rank's
carried memory against its rows of the JAX memory; then the eval and
test epochs (a fresh memory each), and the predictor over a 20-row split
(8 + 8 + a ragged 4), the predictions gathered in batch order.

Tolerances: the bands of ``tests/test_torch_mems.py`` (losses rtol 1e-3,
params rtol 1e-3 / atol 5e-5, the carried memory atol 5e-5, predictions
atol 1e-4 and the test epoch's 1e-3).
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch.config import (
    MeshConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.data.pipeline import PackedSplit
from bert_multimodal_transformer_tpu_torch.models import xlnet as txl
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    make_mesh,
    run_ranks,
)
from bert_multimodal_transformer_tpu_torch.serving import Predictor
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttr

B, S, V, DV, DA, MLEN, ACCUM = 16, 10, 128, 5, 7, 6, 2
LR, N_STEPS = 1e-3, 6
RANK_TIMEOUT_S = 240
LOGITS_ATOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-5


def _inputs(n=B, s=S, seed=0):
    """Left-padded XLNet rows (row 0 unpadded), segments 0 / 2 (<cls>) / 3
    (pads), modality rows zero on pads, labels (``tests/test_torch_mems.py``
    ``_inputs``)."""
    rng = np.random.RandomState(seed)
    n_real = rng.randint(3, s + 1, n)
    n_real[0] = s
    real = np.arange(s)[None, :] >= (s - n_real)[:, None]
    ids = np.where(real, rng.randint(5, V, (n, s)), 2).astype(np.int32)
    segs = np.where(real, 0, 3).astype(np.int32)
    segs[:, -1] = 2
    vis = (rng.randn(n, s, DV) * real[..., None]).astype(np.float32)
    ac = (rng.randn(n, s, DA) * real[..., None]).astype(np.float32)
    labels = rng.uniform(-3, 3, n).astype(np.float32)
    return ids, vis, ac, real.astype(np.int32), segs, labels


TRAIN = [_inputs(seed=20), _inputs(seed=21)]
TAIL_VALID = np.arange(B) < 11
TAIL = tuple(np.where(TAIL_VALID.reshape((B,) + (1,) * (a.ndim - 1)), a, 0)
             .astype(a.dtype) for a in _inputs(seed=22))
LOADER = [(_inputs(n=8, seed=30), np.ones(8, bool)),
          (_inputs(n=8, seed=31), np.ones(8, bool))]
SPLIT = _inputs(n=20, seed=60)


def _rank(rank, params_np):
    """The trainer's memory steps, epochs and the predictor on this rank."""
    mesh = make_mesh(MeshConfig(data_parallel=-1),
                     ["cpu"] * dist.get_world_size())
    cfg = dataclasses.replace(XLNetConfig.tiny(V), mem_len=MLEN, dropout=0.0,
                              summary_last_dropout=0.0,
                              attention_impl="fused")
    model = txl.MagXLNetForSequenceClassification(
        cfg, MultimodalConfig(beta_shift=1.0, dropout_prob=0.0,
                              injection_index=1), DV, DA, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in params_np.items()})
    tr = ttr.Trainer(model=model, mesh=mesh, grad_accum=ACCUM, mem_len=MLEN,
                     tx=toptim.make_optimizer(LR, N_STEPS, 0.1))
    st = tr.create_state_from_params(None, 1)
    mems = tr._init_mems(TRAIN[0], for_train=True)
    losses = []
    for batch in TRAIN:
        loss, mems = tr._train_step_mems(st, tr._put_batch(batch, ACCUM),
                                         mems)
        losses.append(float(loss))
    loss, mems = tr._train_step_mems_masked(st, tr._put_batch(TAIL, ACCUM),
                                            mems, TAIL_VALID)
    losses.append(float(loss))
    params = {k: v.detach().numpy().copy()
              for k, v in model.state_dict().items()}
    preds = tr.test_epoch(st, LOADER)[0]
    pred = Predictor(model, batch_size=8, mem_len=MLEN, mesh=mesh)
    return {"losses": losses, "params": params,
            "mems": [m.numpy().copy() for m in mems],
            "eval": tr.eval_epoch(st, LOADER), "test": preds,
            "predict": pred.predict_split(PackedSplit(*SPLIT))}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model and its init, and the init as a port state dict."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        MultimodalConfig as JMultimodalConfig,
        XLNetConfig as JXLNetConfig,
    )
    from bert_multimodal_transformer_tpu.models import xlnet as jxl
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    cfg = dataclasses.replace(JXLNetConfig.tiny(V), mem_len=MLEN,
                              dropout=0.0, summary_last_dropout=0.0)
    jmodel = jxl.MagXLNetForSequenceClassification(
        cfg, JMultimodalConfig(beta_shift=1.0, dropout_prob=0.0,
                               injection_index=1),
        visual_dim=DV, acoustic_dim=DA)
    ids, vis, ac, mask, segs, _ = TRAIN[0]
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), ids, vis, ac, attention_mask=mask,
        token_type_ids=segs)["params"])
    port = {k: v.numpy() for k, v in xlnet_params_from_flax(params).items()}
    # the tree has no mask_emb (no target_mapping): the port's own zeros
    port["transformer.mask_emb"] = np.zeros((1, 1, 32), np.float32)
    return jmodel, params, port


@pytest.fixture(scope="module")
def ranks(jax_side):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _rank, 2, (jax_side[2],),
                          timeout_s=RANK_TIMEOUT_S, devices=["cpu"] * 2)


@pytest.fixture(scope="module")
def jax_runs(jax_side, ranks):
    """The JAX trainer and predictor with the memory on a two-device data
    mesh; asks for the ranks first, so they run while JAX compiles."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        MeshConfig as JMeshConfig,
    )
    from bert_multimodal_transformer_tpu.data.pipeline import (
        PackedSplit as JPackedSplit,
    )
    from bert_multimodal_transformer_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )
    from bert_multimodal_transformer_tpu.serving import Predictor as JPredictor
    from bert_multimodal_transformer_tpu.training import optim as joptim
    from bert_multimodal_transformer_tpu.training import trainer as jtrainer
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    jmodel, params, _ = jax_side
    mesh = jmake_mesh(JMeshConfig(data_parallel=-1),
                      devices=jax.devices()[:2])
    jtr = jtrainer.Trainer(model=jmodel, mesh=mesh, grad_accum=ACCUM,
                           donate=False, mem_len=MLEN,
                           tx=joptim.make_optimizer(LR, N_STEPS, 0.1))
    st = jtr.create_state_from_params(params, jax.random.PRNGKey(1))
    mems = jtr._init_mems(TRAIN[0], for_train=True)
    losses = []
    for batch in TRAIN:
        st, loss, mems = jtr._train_step_mems(st, jtr._put_batch(batch),
                                              mems)
        losses.append(float(loss))
    st, loss, mems = jtr._train_step_mems_masked(
        st, jtr._put_batch(TAIL), mems, jtr._put_valid(TAIL_VALID))
    losses.append(float(loss))
    tuned = jax.device_get(st.params)
    pred = JPredictor(jmodel, tuned, mesh=mesh, batch_size=8, mem_len=MLEN)
    return {"losses": losses,
            "params": {k: v.numpy() for k, v in
                       xlnet_params_from_flax(tuned).items()},
            "mems": [np.asarray(m) for m in jax.device_get(mems)],
            "eval": jtr.eval_epoch(st, LOADER),
            "test": jtr.test_epoch(st, LOADER)[0],
            "predict": pred.predict_split(JPackedSplit(*SPLIT))}


def test_memory_steps_over_data_ranks_match_jax(ranks, jax_runs):
    """Two memory steps at grad_accum 2 and the masked tail: the losses
    and params of every rank against the JAX trainer's, and each rank's
    carried memory, [B/(2·2), mem_len, D], against its rows of JAX's."""
    out = ranks.result()
    rows = B // (ACCUM * 2)
    for rank, r in enumerate(out):
        np.testing.assert_allclose(r["losses"], jax_runs["losses"],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        for k, w in jax_runs["params"].items():
            np.testing.assert_allclose(r["params"][k], w, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)
        for got, want in zip(r["mems"], jax_runs["mems"], strict=True):
            assert got.shape == (rows, MLEN, 32)
            np.testing.assert_allclose(
                got, want[rank * rows:(rank + 1) * rows], atol=PARAM_ATOL,
                rtol=PARAM_RTOL)
    assert float(np.abs(out[0]["mems"][0]).max()) > 0
    assert out[0]["losses"] == out[1]["losses"]


def test_memory_eval_test_and_predictor_over_data_ranks_match_jax(
        ranks, jax_runs):
    """The eval and test epochs with a fresh memory, and
    ``Predictor(mesh=, mem_len=)`` over 20 rows at batch 8: every rank
    holds all the predictions, in order, against JAX's."""
    for r in ranks.result():
        np.testing.assert_allclose(r["eval"], jax_runs["eval"],
                                   rtol=LOSS_RTOL)
        assert r["test"].shape == (16,)
        np.testing.assert_allclose(r["test"], jax_runs["test"], atol=1e-3,
                                   rtol=LOSS_RTOL)
        assert r["predict"].shape == (20,)
        np.testing.assert_allclose(r["predict"], jax_runs["predict"],
                                   atol=LOGITS_ATOL, rtol=0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_fsdp.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
