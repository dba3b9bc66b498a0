"""The port's GPipe pipeline for MAG-BERT (``parallel/pp.py``,
``PipelineTrainer``, ``make_pp_mesh``) against the JAX package, carrying
the contracts of ``tests/test_pipeline_parallel.py``.

A pipelined step computes what the plain ``Trainer(grad_accum=n_micro)``
step computes: the pipeline changes where each layer runs, not what is
computed. The ranks are CPU processes over gloo
(``parallel/mesh.py::run_ranks``, each mesh's cases in one spawn, under a
timeout of their own, run in the background while the JAX reference
compiles): (2 stages, dp 1), (2 stages, dp 2) and PP×TP (2 stages × 2
model), all at n_micro 2, at dropout 0 in fp32, from the JAX model's
weights (``utils/convert.params_from_flax``; the JAX pipeline layout is
taken by it too), against the JAX one-device ``Trainer(grad_accum=2)``.
Predict against the model's forward, the masked step against the plain
masked step, the inherited epoch driver's history against the plain
trainer's, a checkpoint in the pipeline layout served by
``Predictor.from_checkpoint``, dropout (the loss moves, the same seed
gives the same bits), the planted fault of a pipeline without the
prologue/epilogue sum over stages, and the guards.

Tolerances are the JAX tests': the loss rtol 1e-5 atol 1e-6, params rtol
2e-5 atol 1e-6, the epoch history rtol 1e-4.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
)
from bert_multimodal_transformer_tpu_torch.data.pipeline import (
    BatchIterator,
    PackedSplit,
)
from bert_multimodal_transformer_tpu_torch.models.bert import (
    MagBertForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.parallel import pp
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    make_pp_mesh,
    run_ranks,
)
from bert_multimodal_transformer_tpu_torch.serving import Predictor
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttr
from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)

VIS, AC, V, S, B, L = 5, 7, 97, 10, 16, 4
N_MICRO = 2
LR = 1e-3
RANK_TIMEOUT_S = 240
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6


def _batch(seed, b=B):
    r = np.random.RandomState(seed)
    lengths = r.randint(3, S + 1, b)
    lengths[-1] = S
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    return (r.randint(1, V, (b, S)).astype(np.int32) * mask,
            r.randn(b, S, VIS).astype(np.float32),
            r.randn(b, S, AC).astype(np.float32), mask,
            np.zeros((b, S), np.int32), r.randn(b).astype(np.float32))


BATCH = _batch(0)
TAIL_VALID = np.arange(B) < 11
TAIL = tuple(np.where(TAIL_VALID.reshape((B,) + (1,) * (a.ndim - 1)), a, 0)
             .astype(a.dtype) for a in _batch(1))


def _cfg(rate=0.0, **kw):
    return dataclasses.replace(
        BertConfig.tiny(V), **{
            "num_hidden_layers": L, "attention_impl": "fused",
            "hidden_dropout_prob": rate,
            "attention_probs_dropout_prob": rate, **kw})


def _model(rate=0.0, **kw):
    return MagBertForSequenceClassification(
        _cfg(rate, **kw), MultimodalConfig(dropout_prob=rate), VIS, AC,
        device="cpu")


def _tx():
    # no warmup: the first step moves the params
    return toptim.make_optimizer(LR, 10, warmup_proportion=0.0)


def _splits():
    def split(n, seed):
        return PackedSplit(*_batch(seed, n))

    return split(12, 10), split(8, 11), split(8, 12)


def _loaders(splits):
    train, dev, test = splits
    return (BatchIterator(train, 8, shuffle=True, seed=5,
                          drop_remainder=False),
            BatchIterator(dev, 8, shuffle=False, drop_remainder=False),
            BatchIterator(test, 8, shuffle=False, drop_remainder=False))


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


# ---- the JAX side -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """The JAX tiny MAG-BERT (4 layers, dropout 0): its params from
    PRNGKey(0), and its one-device Trainer(grad_accum=2) step on BATCH."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MultimodalConfig as JMultimodalConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert

    cfg = dataclasses.replace(JBertConfig.tiny(V), num_hidden_layers=L,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    jmodel = jbert.MagBertForSequenceClassification(
        cfg, JMultimodalConfig(dropout_prob=0.0), visual_dim=VIS,
        acoustic_dim=AC)
    tree = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                               *BATCH[:5])["params"])
    return jmodel, tree


@pytest.fixture(scope="module")
def full_params(jax_side):
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    return _np(params_from_flax(jax_side[1]))


@pytest.fixture(scope="module")
def jax_step(jax_side, rank_runs):
    """The JAX plain step's (loss, params as a port state dict); asks for
    the ranks first, so they run while JAX compiles."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        MeshConfig as JMeshConfig,
    )
    from bert_multimodal_transformer_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )
    from bert_multimodal_transformer_tpu.training import optim as joptim
    from bert_multimodal_transformer_tpu.training import trainer as jtrainer
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    jmodel, tree = jax_side
    jtr = jtrainer.Trainer(
        model=jmodel, donate=False,
        tx=joptim.make_optimizer(LR, 10, warmup_proportion=0.0),
        grad_accum=N_MICRO,
        mesh=jmake_mesh(JMeshConfig(data_parallel=1),
                        devices=jax.devices()[:1]))
    st = jtr.create_state_from_params(tree, jax.random.PRNGKey(1))
    st, loss = jtr._train_step(st, jtr._put_batch(BATCH))
    return float(loss), _np(params_from_flax(jax.device_get(st.params)))


# ---- what each rank runs ----------------------------------------------------


def _trainer(mesh, rate=0.0):
    return pp.PipelineTrainer(model=_model(rate), tx=_tx(), mesh=mesh,
                              n_micro=N_MICRO)


def _pp_rank(rank, stages, dp, mp, params_np, tmp):
    """Every case of one (data, pipe, model) mesh on this rank."""
    mesh = make_pp_mesh(stages, data_parallel=dp, model_parallel=mp,
                        devices=["cpu"] * dist.get_world_size())
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    out = {"coords": (mesh.data_rank, mesh.pipe_rank, mesh.model_rank)}
    tr = _trainer(mesh)
    st = tr.create_state_from_params(params, 1)
    out["loss"] = float(tr.train_step(st, BATCH))
    out["params"] = _np(tr.model_params(st))
    out["predict"] = tr.predict(st, _batch(2)).numpy()
    tr = _trainer(mesh)
    st = tr.create_state_from_params(params, 1)
    out["masked"] = (float(tr._train_step_masked(
        st, tr._put_batch(TAIL), TAIL_VALID)), _np(tr.model_params(st)))
    if dp > 1 or mp > 1:
        return out
    # the epoch driver, and its checkpoint served by Predictor
    tr = _trainer(mesh)
    st = tr.create_state_from_params(params, 9)
    _, summary = tr.train(st, *_loaders(_splits()), n_epochs=1)
    out["history"] = summary["history"]
    CheckpointManager(tmp).save(st, st.step)
    out["served_after"] = tr.predict(st, _batch(2)).numpy()
    # dropout on: the loss moves, the same seed gives the same bits
    runs = []
    for _ in range(2):
        tr = _trainer(mesh, rate=0.1)
        st = tr.create_state_from_params(params, 5)
        runs.append((float(tr.train_step(st, BATCH)),
                     _np(tr.model_params(st))))
    out["dropout"] = runs
    # the planted fault: the prologue's and epilogue's gradients not summed
    # over the stages
    right = pp.PipelineTrainer._cross_stage_grads
    pp.PipelineTrainer._cross_stage_grads = lambda self, stage: None
    try:
        tr = _trainer(mesh)
        st = tr.create_state_from_params(params, 1)
        tr.train_step(st, BATCH)
        out["fault"] = _np(tr.model_params(st))
    finally:
        pp.PipelineTrainer._cross_stage_grads = right
    return out


@pytest.fixture(scope="module")
def rank_runs(full_params, tmp_path_factory):
    """{(stages, dp, mp): future of the ranks' results}."""
    tmp = str(tmp_path_factory.mktemp("pp_ckpt"))
    pool = concurrent.futures.ThreadPoolExecutor(3)
    runs = {geo: pool.submit(run_ranks, _pp_rank, int(np.prod(geo)),
                             (*geo, full_params, tmp),
                             timeout_s=RANK_TIMEOUT_S,
                             devices=["cpu"] * int(np.prod(geo)))
            for geo in ((2, 1, 1), (2, 2, 1), (2, 1, 2))}
    runs["ckpt"] = tmp
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def plain(full_params):
    """The port's one-process trainer: the grad_accum=2 step, the masked
    step, the forward, and the epoch driver's history."""
    params = {k: torch.from_numpy(v) for k, v in full_params.items()}
    out = {}
    model = _model()
    model.load_state_dict(params)
    with torch.no_grad():
        b = [torch.from_numpy(a) for a in _batch(2)]
        out["forward"] = model(*b[:3], attention_mask=b[3],
                               token_type_ids=b[4]).reshape(-1).numpy()
    tr = ttr.Trainer(model=_model(), tx=_tx(), grad_accum=N_MICRO)
    st = tr.create_state_from_params(params, 1)
    out["masked"] = (float(tr._train_step_masked(
        st, tr._put_batch(TAIL, N_MICRO), TAIL_VALID)),
        _np(st.model.state_dict()))
    tr = ttr.Trainer(model=_model(), tx=_tx())
    st = tr.create_state_from_params(params, 9)
    out["history"] = tr.train(st, *_loaders(_splits()), n_epochs=1)[1][
        "history"]
    return out


def _close_params(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


# ---- the layout -------------------------------------------------------------


def test_pp_params_roundtrip_and_jax_layout(jax_side, full_params):
    """The pipeline layout round-trips exactly; its stacked layers are the
    JAX pipeline layout's leaves (kernels transposed), and
    ``params_from_flax`` takes the JAX pipeline layout to the same state
    dict as the model tree."""
    from bert_multimodal_transformer_tpu.parallel.pp import (
        pp_params_from_model_params as jax_to_pp,
    )
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    sd = {k: torch.from_numpy(v) for k, v in full_params.items()}
    layout = pp.pp_params_from_model_params(sd)
    assert all(k.split(".")[0] in ("prologue", "layers", "epilogue")
               for k in layout)
    assert layout["layers.intermediate_dense.weight"].shape == (L, 64, 32)
    back = pp.model_params_from_pp_params(layout)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    jpp = jax_to_pp(jax_side[1])
    np.testing.assert_array_equal(
        layout["layers.intermediate_dense.weight"].numpy(),
        np.swapaxes(np.asarray(jpp["layers"]["intermediate_dense"][
            "kernel"]), 1, 2))
    np.testing.assert_array_equal(
        layout["prologue.MAG.w_hv_v"].numpy(),
        np.asarray(jpp["prologue"]["MAG"]["w_hv_v"]))
    from_pp = params_from_flax(jpp)
    assert set(from_pp) == set(sd)
    assert all(torch.equal(from_pp[k], sd[k]) for k in sd)


# ---- the step ---------------------------------------------------------------


@pytest.mark.parametrize("geo", [(2, 1, 1), (2, 2, 1)],
                         ids=["2stages-dp1", "2stages-dp2"])
def test_pp_step_matches_jax_plain_grad_accum_step(geo, rank_runs,
                                                   jax_step):
    ranks = rank_runs[geo].result()
    ref_loss, ref_params = jax_step
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
    _close_params(ranks[0]["params"], ref_params)


def test_pp_tp_step_matches_jax_plain_grad_accum_step(rank_runs, jax_step):
    """PP×TP: 2 stages × 2 model ranks, the FFN Megatron-split inside
    each stage."""
    ranks = rank_runs[(2, 1, 2)].result()
    assert sorted(r["coords"] for r in ranks) == [
        (0, p, m) for p in range(2) for m in range(2)]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], jax_step[0], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
    _close_params(ranks[0]["params"], jax_step[1])


@pytest.mark.parametrize("geo", [(2, 1, 1), (2, 2, 1), (2, 1, 2)],
                         ids=["2stages", "2stages-dp2", "2stages-mp2"])
def test_pp_predict_matches_model_forward(geo, rank_runs, plain):
    """The deterministic pipelined forward after one step is the plain
    forward of the stepped params (every rank holds the logits)."""
    for r in rank_runs[geo].result():
        model = _model()
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in r["params"].items()})
        with torch.no_grad():
            b = [torch.from_numpy(a) for a in _batch(2)]
            want = model(*b[:3], attention_mask=b[3],
                         token_type_ids=b[4]).reshape(-1).numpy()
        np.testing.assert_allclose(r["predict"], want, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("geo", [(2, 1, 1), (2, 2, 1), (2, 1, 2)],
                         ids=["2stages", "2stages-dp2", "2stages-mp2"])
def test_pp_masked_step_matches_plain_masked_step(geo, rank_runs, plain):
    loss, params = rank_runs[geo].result()[0]["masked"]
    np.testing.assert_allclose(loss, plain["masked"][0], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    _close_params(params, plain["masked"][1])


def test_pp_epoch_driver_inherited(rank_runs, plain):
    """``Trainer.train`` (train epoch with a ragged tail, eval, test
    scoring) on the pipeline trainer gives the plain trainer's record."""
    (got,) = rank_runs[(2, 1, 1)].result()[0]["history"]
    (want,) = plain["history"]
    for key in ("train_loss", "valid_loss", "test_acc", "test_mae"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_pp_checkpoint_serves_through_predictor(rank_runs):
    """The checkpoint holds the pipeline layout; ``Predictor.from_
    checkpoint`` serves it on the model layout with the pipeline's
    logits."""
    ranks = rank_runs[(2, 1, 1)].result()
    saved = CheckpointManager(rank_runs["ckpt"]).restore_params()
    assert pp.is_pp_layout(saved)
    assert saved["layers.attention.qkv.weight"].shape[0] == L
    pred = Predictor.from_checkpoint(_model(), rank_runs["ckpt"],
                                     batch_size=B)
    split = PackedSplit(*_batch(2))
    np.testing.assert_allclose(pred.predict_split(split),
                               ranks[0]["served_after"], rtol=1e-5,
                               atol=1e-6)


def test_pp_dropout_moves_the_step_and_replays(rank_runs, jax_step):
    """Dropout on: the step runs and leaves the dropout-0 step's loss and
    params, and the same seed gives the same bits."""
    (l1, p1), (l2, p2) = rank_runs[(2, 1, 1)].result()[0]["dropout"]
    assert l1 == l2
    assert all(np.array_equal(p1[k], p2[k]) for k in p1)
    assert np.isfinite(l1) and l1 != jax_step[0]
    assert max(float(np.abs(p1[k] - v).max())
               for k, v in jax_step[1].items()) > 1e-4


def test_pp_without_the_stage_sum_diverges(rank_runs, jax_step):
    """The planted fault: without ``_cross_stage_grads`` stage 0's
    epilogue and stage 1's prologue never see a gradient, so each stage's
    replica leaves the reference (the whole model read on that stage)."""
    ranks = rank_runs[(2, 1, 1)].result()

    def gap(rank, name):
        return float(np.abs(ranks[rank]["fault"][name]
                            - jax_step[1][name]).max())

    assert gap(0, "classifier.weight") > 1e-4
    assert gap(1, "bert.embeddings.word_embeddings.weight") > 1e-4
    assert gap(0, "bert.embeddings.word_embeddings.weight") < 1e-6


# ---- the guards -------------------------------------------------------------


def _pp_mesh(stages=2, model=1):
    """A (1, stages, model) pipeline mesh seen from rank 0, with no
    process group (the guards read only its shape)."""
    return Mesh(data_size=1, model_size=model, rank=0,
                device=torch.device("cpu"), backend=None, pipe_size=stages,
                pipelined=True)


@pytest.mark.parametrize("kw,model_kw,match", [
    ({}, {"num_hidden_layers": 3}, "divide evenly over 2 pipeline stages"),
    ({}, {"num_labels": 3}, "num_labels must be 1"),
    ({"grad_accum": 2}, {}, "grad_accum must stay 1"),
    ({"tp_shard_attention": True}, {}, "does not compose with the pipeline"),
    ({"fsdp": True}, {}, "fsdp does not compose"),
    ({"mem_len": 4}, {}, "mem_len"),
    ({"n_micro": 0}, {}, "n_micro must be >= 1"),
    ({"mesh": None}, {}, "needs a mesh with a 'pipe' axis"),
], ids=["layers", "num_labels", "grad_accum", "tp_shard_attention", "fsdp",
        "mem_len", "n_micro", "no_pipe_mesh"])
def test_pp_validates_geometry(kw, model_kw, match):
    kw = {"mesh": _pp_mesh(), "n_micro": 2, **kw}
    with pytest.raises(ValueError, match=match):
        pp.PipelineTrainer(model=_model(**model_kw), tx=_tx(), **kw)


def test_pp_refuses_injection_past_the_prologue():
    model = MagBertForSequenceClassification(
        _cfg(), MultimodalConfig(injection_index=1), VIS, AC, device="cpu")
    with pytest.raises(ValueError, match="injection_index != 0"):
        pp.PipelineTrainer(model=model, tx=_tx(), mesh=_pp_mesh())


def test_pp_mesh_shape_messages():
    """``make_pp_mesh`` checks its shape with the JAX messages before it
    touches a process group."""
    with pytest.raises(ValueError, match=r"pp mesh 1x4x1 needs 4 devices, "
                       r"have 2"):
        make_pp_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="without a place"):
        make_pp_mesh(2, devices=["cpu"] * 4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_resume.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
