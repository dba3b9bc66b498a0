"""The port's tensor parallelism for MAG-BERT (``parallel/mesh.py``,
``parallel/tp.py``, the model's TP branches, ``Trainer(mesh=...)``,
``Predictor(mesh=...)`` and ``driver --model_parallel``) against the JAX
package's single-device ``Trainer``, carrying the BERT contracts of
``tests/test_tensor_parallel.py``.

The ranks are CPU processes over gloo, spawned by
``parallel/mesh.py::run_ranks`` under a timeout of their own: one run of a
1×2 mesh (data × model) and one of 2×2 each compute every case once
(module-scoped), and the tests read their results; a 2×1 mesh steps the
model with ``qkv_fusion`` (#18/#19's plain versions) against one rank. Both sides start from
the same weights (the JAX params through ``utils/convert.params_from_flax``,
which ``Trainer.create_state_from_params`` shards rank by rank) and see the
same batches, at ``BertConfig.tiny()`` in fp32.

Tolerances: the two-step losses at dropout 0 rtol 1e-5 against JAX (fp32,
the model axis sums its partial products in another order); the first
step's gradients against the port's single-process step, each parameter
within 1e-5 of its largest gradient (the same reordering); with dropout
on, the TP step against the port's own single-process step at rtol 1e-5
(the split kernels' Philox offsets and the head-sliced einsum mask draw
exactly the single device's masks); ``Predictor`` logits 1e-5; the two
data ranks' losses and updated parameters against one rank's at rtol 1e-5
(atol 1e-7 for parameters near zero).
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MeshConfig,
    MultimodalConfig,
)
from bert_multimodal_transformer_tpu_torch.data.pipeline import PackedSplit
from bert_multimodal_transformer_tpu_torch.models.bert import (
    MagBertForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa
from bert_multimodal_transformer_tpu_torch.parallel import tp
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    make_mesh,
    run_ranks,
)
from bert_multimodal_transformer_tpu_torch.serving import Predictor
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttr

DV, DA, S, B, V = 3, 4, 12, 8, 128
LR = 1e-3
RANK_TIMEOUT_S = 240
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5


def make_batch(seed):
    """A seeded batch with ragged lengths (one row fully real)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, S + 1, B)
    lengths[-1] = S
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    return (rng.randint(1, V, (B, S)).astype(np.int32) * mask,
            rng.randn(B, S, DV).astype(np.float32),
            rng.randn(B, S, DA).astype(np.float32),
            mask, np.zeros((B, S), np.int32),
            rng.uniform(-3, 3, (B,)).astype(np.float32))


BATCHES = [make_batch(10), make_batch(11)]


def _cfg(impl, rate=0.0, mesh=None):
    return dataclasses.replace(
        BertConfig.tiny(V), attention_impl=impl, hidden_dropout_prob=rate,
        attention_probs_dropout_prob=rate, tp_attention_mesh=mesh)


def _model(impl, rate=0.0, mesh=None):
    return MagBertForSequenceClassification(
        _cfg(impl, rate, mesh), MultimodalConfig(dropout_prob=rate), DV, DA,
        device="cpu")


def _losses(model, params, mesh=None, shard_attention=False, seed=1):
    """Two train steps on BATCHES from ``params`` (a full state dict)."""
    tr = ttr.Trainer(model=model, tx=toptim.make_optimizer(LR, 2),
                     mesh=mesh, tp_shard_attention=shard_attention)
    st = tr.create_state_from_params(params, seed)
    return [float(tr._train_step(st, tr._put_batch(b))) for b in BATCHES]


def _first_grads(model, params, mesh=None, shard_attention=False):
    """One train step on BATCHES[0] from ``params``: the gradients it
    applied, by parameter name (this rank's chunks under a mesh)."""
    tr = ttr.Trainer(model=model, tx=toptim.make_optimizer(LR, 2),
                     mesh=mesh, tp_shard_attention=shard_attention)
    st = tr.create_state_from_params(params, 1)
    tr._train_step(st, tr._put_batch(BATCHES[0]))
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


# The ragged tail: 5 valid rows of 8, zero-padded (a 2×2 mesh gives data
# rank 0 four of them and data rank 1 one).
TAIL_VALID = np.arange(B) < 5
TAIL = tuple(np.where(TAIL_VALID.reshape((B,) + (1,) * (a.ndim - 1)), a, 0)
             .astype(a.dtype) for a in make_batch(12))


def _masked_loss(model, params, mesh=None, shard_attention=False):
    """One masked step on TAIL from ``params``: its loss, and the
    classifier's updated weight."""
    tr = ttr.Trainer(model=model, tx=toptim.make_optimizer(LR, 2),
                     mesh=mesh, tp_shard_attention=shard_attention)
    st = tr.create_state_from_params(params, 1)
    loss = float(tr._train_step_masked(st, tr._put_batch(TAIL), TAIL_VALID))
    return loss, model.classifier.weight.detach().numpy().copy()


def _jax_side():
    """The JAX tiny MAG-BERT at dropout 0 from PRNGKey(0): (model, params
    tree)."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MultimodalConfig as JMultimodalConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert

    jcfg = dataclasses.replace(JBertConfig.tiny(V), hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    jmodel = jbert.MagBertForSequenceClassification(
        jcfg, JMultimodalConfig(dropout_prob=0.0), visual_dim=DV,
        acoustic_dim=DA)
    init = jax.jit(jmodel.init)
    return jmodel, init(jax.random.PRNGKey(0), *BATCHES[0][:5])["params"]


@pytest.fixture(scope="module")
def jax_side():
    return _jax_side()


@pytest.fixture(scope="module")
def full_params(jax_side):
    """The JAX model's initial params as a port state dict (numpy, so the
    ranks receive them pickled)."""
    import jax

    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    params = params_from_flax(jax.device_get(jax_side[1]))
    return {k: v.numpy() for k, v in params.items()}


@pytest.fixture(scope="module")
def jax_losses(jax_side, rank_runs):
    """The JAX single-device Trainer's two losses at dropout 0 (einsum;
    fp32 fused is the same math). It asks for ``rank_runs`` first, so the
    ranks run while it compiles."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        MeshConfig as JMeshConfig,
    )
    from bert_multimodal_transformer_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )
    from bert_multimodal_transformer_tpu.training import optim as joptim
    from bert_multimodal_transformer_tpu.training import trainer as jtrainer

    jmodel, params = jax_side
    jtr = jtrainer.Trainer(
        model=jmodel, tx=joptim.make_optimizer(LR, 2), donate=False,
        mesh=jmake_mesh(JMeshConfig(data_parallel=1),
                        devices=jax.devices()[:1]))
    st = jtr.create_state_from_params(params, jax.random.PRNGKey(1))
    out = []
    for b in BATCHES:
        st, loss = jtr._train_step(st, jtr._put_batch(b))
        out.append(float(loss))
    return out


def _serving_split():
    rng = np.random.RandomState(20)
    n = 13  # a ragged last batch at batch 8
    lengths = rng.randint(3, S + 1, n)
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    return PackedSplit(rng.randint(1, V, (n, S)).astype(np.int32) * mask,
                       rng.randn(n, S, DV).astype(np.float32),
                       rng.randn(n, S, DA).astype(np.float32), mask,
                       np.zeros((n, S), np.int32),
                       rng.uniform(-3, 3, n).astype(np.float32))


# ---- what each rank runs ----------------------------------------------------


def _tp_rank(rank, model_parallel, params_np):
    """Every case of one mesh, on this rank; returns rank 0's view (and
    each rank's shard facts)."""
    mesh = make_mesh(MeshConfig(data_parallel=-1,
                                model_parallel=model_parallel),
                     ["cpu"] * dist.get_world_size())
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    out = {"coords": (mesh.data_rank, mesh.model_rank)}
    for impl in ("fused", "einsum"):
        out[f"tp_{impl}"] = _losses(_model(impl, mesh=mesh), params, mesh,
                                    shard_attention=True)
    out["ffn_only_fused"] = _losses(_model("fused"), params, mesh)
    for impl in ("fused", "einsum"):
        out[f"grads_{impl}"] = _first_grads(_model(impl, mesh=mesh), params,
                                            mesh, shard_attention=True)
    summed = tp.sync_grads
    tp.sync_grads = lambda model, mesh: None  # a planted fault
    try:
        out["grads_unsummed"] = _first_grads(
            _model("fused", mesh=mesh), params, mesh, shard_attention=True)
    finally:
        tp.sync_grads = summed
    out["masked"] = _masked_loss(_model("fused", mesh=mesh), params, mesh,
                                 shard_attention=True)
    if mesh.data_size == 1:
        for impl in ("fused", "einsum"):
            out[f"dropout_{impl}"] = _losses(_model(impl, 0.1, mesh),
                                             params, mesh,
                                             shard_attention=True, seed=7)
        model = _model("fused", mesh=mesh)
        model.load_state_dict(params)
        pred = Predictor(model, batch_size=B, mesh=mesh)
        out["predict"] = pred.predict_split(_serving_split())
        attn = model.bert.encoder.layer[0].attention
        out["attn_out_weight"] = attn.output_dense.weight.detach().numpy()
        out["ffn_in_weight"] = model.bert.encoder.layer[
            0].intermediate_dense.weight.detach().numpy()
        full = tp.gather_state_dict(model.state_dict(), mesh,
                                    shard_attention=True)
        out["gathered"] = {k: v.numpy() for k, v in full.items()}
    else:
        out["decorrelation"] = _decorrelation(mesh)
    return out


def _decorrelation(mesh):
    """``fused_attention_tp`` on identical examples in every row: the same
    local row on different data shards must draw different dropout (the
    JAX ``test_tp_fused_attention_dropout_decorrelated_across_data_
    shards``); deterministic, they agree. Returns the data axis's gathered
    outputs."""
    h, dh = 4 // mesh.model_size, 8
    rng = np.random.RandomState(0)
    # one example per data rank, the same example on each
    q, k, v = (torch.from_numpy(rng.randn(1, 4, S, dh).astype(np.float32))
               [:, mesh.model_rank * h:(mesh.model_rank + 1) * h]
               for _ in range(3))
    mask = torch.ones(1, S)
    kw = dict(mesh=mesh, scale=dh ** -0.5, dropout_rate=0.5)
    outs = {}
    for det in (False, True):
        o = tfa.fused_attention_tp(
            q, k, v, mask, deterministic=det,
            dropout_rng=torch.Generator().manual_seed(7), **kw)
        outs[det] = mesh.all_gather(o, mesh.data_axis).numpy()
    return outs


def _qkvproj_model(qkv_residual):
    """The tiny fused model with the QKV projection inside the attention
    kernels (#18/#19's plain versions), dropout 0."""
    return MagBertForSequenceClassification(
        dataclasses.replace(_cfg("fused"), qkv_fusion=True,
                            qkv_residual=qkv_residual),
        MultimodalConfig(dropout_prob=0.0), DV, DA, device="cpu")


def _qkvproj_steps(params, mesh=None):
    """Two steps of ``_qkvproj_model`` from ``params`` for both backward
    variants: {qkv_residual: (losses, the updated state dict)}."""
    out = {}
    for residual in (False, True):
        model = _qkvproj_model(residual)
        losses = _losses(model, params, mesh)
        out[residual] = (losses, {k: v.numpy().copy()
                                  for k, v in model.state_dict().items()})
    return out


def _dp_qkvproj_rank(rank, params_np):
    """Two data ranks (model axis 1) stepping the qkv_fusion model."""
    mesh = make_mesh(MeshConfig(data_parallel=-1, model_parallel=1),
                     ["cpu"] * dist.get_world_size())
    return _qkvproj_steps({k: torch.from_numpy(v)
                           for k, v in params_np.items()}, mesh)


DRIVER_ARGV = ["--synthetic", "--tiny", "--device", "cpu",
               "--model_parallel", "2", "--tp_shard_attention",
               "--attention_impl", "fused", "--n_epochs", "1",
               "--train_batch_size", "8", "--synthetic_sizes", "16", "8",
               "8", "--seed", "3"]


@pytest.fixture(scope="module")
def rank_runs(full_params):
    """The 1×2 and the 2×2 mesh's runs, the driver's two ranks and two
    data ranks of the qkv_fusion model, started together in the
    background: {"1x2", "2x2", "driver", "dp_qkvproj": future}."""
    pool = concurrent.futures.ThreadPoolExecutor(4)
    runs = {f"{n // 2}x2": pool.submit(
        run_ranks, _tp_rank, n, (2, full_params), timeout_s=RANK_TIMEOUT_S,
        devices=["cpu"] * n) for n in (2, 4)}
    runs["driver"] = pool.submit(tdriver.run, DRIVER_ARGV,
                                 rank_timeout_s=RANK_TIMEOUT_S)
    runs["dp_qkvproj"] = pool.submit(
        run_ranks, _dp_qkvproj_rank, 2, (full_params,),
        timeout_s=RANK_TIMEOUT_S, devices=["cpu"] * 2)
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def tp_1x2(rank_runs):
    return rank_runs["1x2"].result()


@pytest.fixture(scope="module")
def tp_2x2(rank_runs):
    return rank_runs["2x2"].result()


# ---- the rules, the mesh, the guards (in this process) ---------------------


def test_tp_pspec_rules():
    rule = tp.tp_pspec_for_path
    base = "bert.encoder.layer.0."
    assert rule(base + "intermediate_dense.weight") == (MODEL_AXIS, None)
    assert rule(base + "intermediate_dense.bias") == (MODEL_AXIS,)
    assert rule(base + "output_dense.weight") == (None, MODEL_AXIS)
    # the row-parallel bias is added after the sum: replicated
    assert rule(base + "output_dense.bias") == ()
    # attention stays replicated unless shard_attention
    assert rule(base + "attention.output_dense.weight") == ()
    assert rule(base + "attention.output_dense.weight",
                shard_attention=True) == (None, MODEL_AXIS)
    assert rule(base + "attention.output_dense.bias",
                shard_attention=True) == ()
    # the packed qkv cannot be head-aligned by one chunk: replicated
    assert rule(base + "attention.qkv.weight", shard_attention=True) == ()
    assert rule("classifier.weight") == ()
    assert rule("bert.MAG.w_hv_v", shard_attention=True) == ()


def test_make_mesh_validation():
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(MeshConfig(data_parallel=-1, model_parallel=3),
                  devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data_parallel=-1, model_parallel=16),
                  devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data_parallel=4, model_parallel=4),
                  devices=["cpu"] * 8)
    # a right shape still needs one started rank per device
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        make_mesh(MeshConfig(data_parallel=-1, model_parallel=2),
                  devices=["cpu"] * 8)
    one = make_mesh(devices=["cpu"])
    assert (one.data_size, one.model_size, one.rank, one.backend) == (
        1, 1, 0, None)


def _fake_mesh(data=1, model=2, rank=0):
    """A mesh place with no process group: the guards and the shard
    arithmetic run before any collective."""
    return Mesh(data_size=data, model_size=model, rank=rank,
                device=torch.device("cpu"), backend=None)


def test_trainer_guards_fused_tp_without_mesh():
    """tp_shard_attention + fused needs the model built with
    tp_attention_mesh (the JAX guard); a model axis > 1, n_head divisible
    by it; a tp_attention_mesh model needs tp_shard_attention."""
    tx = toptim.make_optimizer(LR, 1)
    mesh = _fake_mesh()
    with pytest.raises(ValueError, match="tp_attention_mesh"):
        ttr.Trainer(model=_model("fused"), tx=tx, mesh=mesh,
                    tp_shard_attention=True)
    with pytest.raises(ValueError, match="model axis > 1"):
        ttr.Trainer(model=_model("einsum"), tx=tx, tp_shard_attention=True)
    with pytest.raises(ValueError, match="divisible"):
        ttr.Trainer(model=_model("einsum"), tx=tx,
                    mesh=_fake_mesh(model=4), tp_shard_attention=True)
    with pytest.raises(ValueError, match="tp_shard_attention=True"):
        ttr.Trainer(model=_model("fused", mesh=mesh), tx=tx, mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        ttr.Trainer(model=_model("einsum"), tx=tx, mesh=object())


def test_shard_state_dict_chunks(full_params):
    """Each model rank keeps its chunk of the split tensors and the whole
    of the rest; the chunks put back together give the full tensors."""
    full = {k: torch.from_numpy(v) for k, v in full_params.items()}
    shards = [tp.shard_state_dict(full, _fake_mesh(rank=r), True)
              for r in range(2)]
    for name, t in full.items():
        spec = tp.tp_pspec_for_path(name, shard_attention=True)
        if MODEL_AXIS not in spec:
            assert all(torch.equal(s[name], t) for s in shards), name
            continue
        dim = spec.index(MODEL_AXIS)
        assert shards[0][name].shape[dim] == t.shape[dim] // 2, name
        assert torch.equal(torch.cat([s[name] for s in shards], dim), t)


def test_sharded_init_draws_the_single_device_weights():
    """``init_params`` on a sharded model draws each split weight whole
    and keeps the chunk: every rank holds what one device would."""
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    single = _model("einsum")
    single.init_params(gen())
    full = single.state_dict()
    for rank in range(2):
        model = tp.shard_model_(_model("einsum"), _fake_mesh(rank=rank),
                                shard_attention=True)
        model.init_params(gen())
        want = tp.shard_state_dict(full, _fake_mesh(rank=rank), True)
        for name, t in model.state_dict().items():
            assert torch.equal(t, want[name]), name


# ---- on the ranks --------------------------------------------------------


@pytest.mark.parametrize("case", ["tp_fused", "tp_einsum", "ffn_only_fused"])
def test_tp_losses_match_jax_single_device(jax_losses, tp_1x2, case):
    """Model axis 2: the two-step losses of head-sharded fused (#8/#10 via
    their plain versions) and einsum attention, and of the FFN split alone
    (attention replicated, the packed kernels), equal the JAX
    single-device Trainer's, on every rank."""
    for r in tp_1x2:
        np.testing.assert_allclose(r[case], jax_losses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", ["tp_fused", "tp_einsum", "ffn_only_fused"])
def test_tp_dp_losses_match_jax_single_device(jax_losses, tp_2x2, case):
    """A 2×2 mesh: each data rank takes half the rows, the gradients and
    the loss summed over the data axis."""
    assert [r["coords"] for r in tp_2x2] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in tp_2x2:
        np.testing.assert_allclose(r[case], jax_losses, rtol=LOSS_RTOL)


def _grad_gaps(got, want, model_rank):
    """Each parameter's max |Δ| of a rank's gradient to its chunk of the
    single-process one, over that chunk's max |·|."""
    gaps = {}
    for name, g in got.items():
        w = tp.shard_tensor(torch.from_numpy(want[name]),
                            tp.tp_pspec_for_path(name, shard_attention=True),
                            _fake_mesh(rank=model_rank)).numpy()
        assert g.shape == w.shape, name
        gaps[name] = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    return gaps


@pytest.mark.parametrize("mesh_run", ["tp_1x2", "tp_2x2"])
@pytest.mark.parametrize("impl", ["fused", "einsum"])
def test_tp_first_step_gradients_equal_single_process(request, full_params,
                                                      mesh_run, impl):
    """Every parameter's first-step gradient on every rank (the split ones
    their chunk, the replicated qkv summed over the model axis, all summed
    over the data axis) equals the single-process step's."""
    params = {k: torch.from_numpy(v) for k, v in full_params.items()}
    want = _first_grads(_model(impl), params)
    for r in request.getfixturevalue(mesh_run):
        got = r[f"grads_{impl}"]
        assert set(got) == set(want)
        gaps = _grad_gaps(got, want, r["coords"][1])
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])


def test_unsummed_qkv_gradient_fails_the_gradient_check(tp_1x2,
                                                        full_params):
    """With ``sync_grads`` skipped, each rank's qkv gradient holds only
    its heads' columns: the check above must see it."""
    params = {k: torch.from_numpy(v) for k, v in full_params.items()}
    want = _first_grads(_model("fused"), params)
    for r in tp_1x2:
        gaps = _grad_gaps(r["grads_unsummed"], want, r["coords"][1])
        bad = {n for n, gap in gaps.items() if gap > GRAD_TOL}
        assert bad and all(".attention.qkv." in n for n in bad), bad


@pytest.mark.parametrize("mesh_run", ["tp_1x2", "tp_2x2"])
def test_masked_tail_weighs_by_the_global_valid_count(request, full_params,
                                                      mesh_run):
    """The ragged tail's masked step: on every rank the loss and the
    updated (replicated) classifier equal the single-process step's, the
    2×2 mesh's data ranks holding 4 and 1 of the 5 valid rows."""
    params = {k: torch.from_numpy(v) for k, v in full_params.items()}
    want_loss, want_w = _masked_loss(_model("fused"), params)
    for r in request.getfixturevalue(mesh_run):
        loss, w = r["masked"]
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(w, want_w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl", ["fused", "einsum"])
def test_tp_dropout_step_equals_single_process(tp_1x2, full_params, impl):
    """Dropout on (hidden, MAG, attention probs 0.1): the TP steps equal
    the port's single-process steps from the same seed."""
    params = {k: torch.from_numpy(v) for k, v in full_params.items()}
    want = _losses(_model(impl, 0.1), params, seed=7)
    for r in tp_1x2:
        np.testing.assert_allclose(r[f"dropout_{impl}"], want,
                                   rtol=LOSS_RTOL)
    assert want[0] != _losses(_model(impl, 0.0), params)[0]


@pytest.mark.parametrize("qkv_residual", [False, True])
def test_dp_qkv_fusion_steps_equal_one_rank(rank_runs, full_params,
                                            qkv_residual):
    """Two data ranks over gloo, each with half the rows, stepping the
    model with ``qkv_fusion`` (#19 re-projecting or reading the saved
    projection): the two losses and every updated parameter equal one
    rank's two steps (the JAX contract of ``tests/test_shard_map.py``:
    N-way data parallelism gives the 1-way loss)."""
    params = {k: torch.from_numpy(v) for k, v in full_params.items()}
    want_losses, want = _qkvproj_steps(params)[qkv_residual]
    name = "bert.encoder.layer.0.attention.qkv.weight"
    assert not np.allclose(want[name], full_params[name], rtol=1e-5,
                           atol=1e-7)
    for r in rank_runs["dp_qkvproj"].result():
        losses, got = r[qkv_residual]
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_predictor_mesh_matches_single_process(tp_1x2, full_params):
    model = _model("fused")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in full_params.items()})
    want = Predictor(model, batch_size=B).predict_split(_serving_split())
    for r in tp_1x2:
        np.testing.assert_allclose(r["predict"], want, rtol=1e-5, atol=1e-6)


def test_attention_output_dense_row_shard(tp_1x2, full_params):
    """Under shard_attention each rank holds its heads' input columns of
    ``attention.output_dense`` and its rows of ``intermediate_dense``; the
    model axis gathers the full state dict back."""
    name = "bert.encoder.layer.0.attention.output_dense.weight"
    d = BertConfig.tiny(V).hidden_size
    for m, r in enumerate(tp_1x2):
        cols = slice(m * d // 2, (m + 1) * d // 2)
        np.testing.assert_array_equal(r["attn_out_weight"],
                                      full_params[name][:, cols])
        assert r["ffn_in_weight"].shape == (
            BertConfig.tiny(V).intermediate_size // 2, d)
        assert set(r["gathered"]) == set(full_params)
        for k, v in r["gathered"].items():
            assert v.shape == full_params[k].shape, k
        np.testing.assert_array_equal(r["gathered"][name], full_params[name])


def test_tp_fused_attention_dropout_decorrelated_across_data_shards(
        tp_2x2):
    outs = tp_2x2[0]["decorrelation"]
    drop, det = outs[False], outs[True]
    # data shard 0 holds example 0, shard 1 example 1, both identical
    assert np.any(drop[0] != drop[1]), "data shards replay the same mask"
    np.testing.assert_array_equal(det[0], det[1])


def test_driver_tp_shard_attention_fused_exits_0(rank_runs):
    """``driver --model_parallel 2 --tp_shard_attention --attention_impl
    fused`` on the CPU: two ranks over gloo, exit 0, one finite epoch."""
    rc, results = rank_runs["driver"].result()
    assert rc == 0
    assert len(results) == 2 and all(r["rc"] == 0 for r in results)
    for r in results:
        (rec,) = r["history"]
        assert np.isfinite(rec["train_loss"]) and np.isfinite(
            rec["valid_loss"])
    assert [r["backend"] for r in results] == ["gloo", "gloo"]
    np.testing.assert_allclose(results[1]["history"][0]["train_loss"],
                               results[0]["history"][0]["train_loss"],
                               rtol=0)


def test_driver_xlnet_model_parallel_exits_2(capsys):
    rc = tdriver.main(["--model", "xlnet-base-cased", "--model_parallel",
                       "2", "--synthetic", "--tiny", "--device", "cpu"])
    assert rc == 2
    assert "ROADMAP A.10" in capsys.readouterr().err


def test_driver_tp_guards_exit_2(capsys):
    for argv, msg in (
            (["--tp_shard_attention"], "requires --model_parallel > 1"),
            (["--model_parallel", "4", "--tp_shard_attention"],
             "n_head (2) divisible")):
        rc = tdriver.main(argv + ["--synthetic", "--tiny", "--device",
                                  "cpu"])
        assert rc == 2 and msg in capsys.readouterr().err
