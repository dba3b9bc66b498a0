"""The port's FSDP (``parallel/fsdp.py``, ``Trainer(fsdp=True)``) against the
JAX package, carrying the contracts of ``tests/test_fsdp.py``.

* ``fsdp_pspec_for_leaf`` equals the JAX function on a table of shapes
  (ties, no divisible dimension, TP bases), and the port's per-parameter
  specs put the same elements of every leaf on a data rank as the JAX
  ``make_fsdp_state_shardings`` does (the port's ``nn.Linear`` weights are
  the JAX kernels transposed), with no ranks;
* the FSDP step on CPU ranks over gloo (``parallel/mesh.py::run_ranks``,
  spawned under a timeout of their own and run in the background while
  the JAX references compile): BERT and XLNet on 2 data ranks, BERT with
  grad accumulation on the fused branch (the kernels' plain versions),
  and FSDP×TP on 2 × 2 ranks, against the JAX plain ``Trainer`` step on
  one device from the same weights (``utils/convert.params_from_flax``)
  and batches, at dropout 0 in fp32;
* the masked, eval and predict paths against the port's one-process
  trainer, checkpoint save, restore and resume bit for bit, the shards
  between steps, the step and generator replicated, and clipping by the
  whole model's norm.

Tolerances are the JAX tests': losses rtol 1e-5 against JAX and 1e-6
against the port's own one-process step (``test_fsdp.py``'s FSDP losses),
params rtol 2e-5 atol 1e-6.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MeshConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.models.bert import (
    MagBertForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.models.xlnet import (
    MagXLNetForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.parallel import fsdp
from bert_multimodal_transformer_tpu_torch.parallel import tp
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    run_ranks,
)
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttr
from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)

DV, DA, S, B, V = 3, 4, 12, 8, 128
LR = 1e-3
RANK_TIMEOUT_S = 240
JAX_LOSS_RTOL = 1e-5
FSDP_LOSS_RTOL = 1e-6
PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6


def make_batch(seed):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, S + 1, B)
    lengths[-1] = S
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    return (rng.randint(1, V, (B, S)).astype(np.int32) * mask,
            rng.randn(B, S, DV).astype(np.float32),
            rng.randn(B, S, DA).astype(np.float32),
            mask, np.zeros((B, S), np.int32),
            rng.uniform(-3, 3, (B,)).astype(np.float32))


BATCHES = [make_batch(30), make_batch(31)]
TAIL_VALID = np.arange(B) < 5
TAIL = tuple(np.where(TAIL_VALID.reshape((B,) + (1,) * (a.ndim - 1)), a, 0)
             .astype(a.dtype) for a in make_batch(32))


def _model(family, impl="fused", mesh=None):
    if family == "bert":
        cfg = dataclasses.replace(
            BertConfig.tiny(V), attention_impl=impl, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, tp_attention_mesh=mesh)
        return MagBertForSequenceClassification(
            cfg, MultimodalConfig(dropout_prob=0.0), DV, DA, device="cpu")
    cfg = dataclasses.replace(
        XLNetConfig.tiny(V), attention_impl=impl, dropout=0.0,
        summary_last_dropout=0.0, tp_attention_mesh=mesh)
    return MagXLNetForSequenceClassification(
        cfg, MultimodalConfig(dropout_prob=0.0, injection_index=1), DV, DA,
        device="cpu")


def _trainer(model, mesh=None, fsdp_on=False, grad_accum=1, shard=False,
             max_grad_norm=0.0):
    return ttr.Trainer(model=model,
                       tx=toptim.make_optimizer(LR, 4,
                                                max_grad_norm=max_grad_norm),
                       mesh=mesh, fsdp=fsdp_on, grad_accum=grad_accum,
                       tp_shard_attention=shard)


def _steps(tr, params, grad_accum=1):
    """Two steps on BATCHES from ``params``: (losses, the full state dict
    after them as numpy)."""
    st = tr.create_state_from_params(params, 1)
    losses = [float(tr._train_step(st, tr._put_batch(b, grad_accum)))
              for b in BATCHES]
    full = tp.full_state_dict(st.model)
    return losses, {k: v.detach().numpy().copy() for k, v in full.items()}


# ---- the JAX side -----------------------------------------------------------


def _jax_model(family):
    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MultimodalConfig as JMultimodalConfig,
        XLNetConfig as JXLNetConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert
    from bert_multimodal_transformer_tpu.models import xlnet as jxlnet

    if family == "bert":
        cfg = dataclasses.replace(JBertConfig.tiny(V),
                                  hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
        return jbert.MagBertForSequenceClassification(
            cfg, JMultimodalConfig(dropout_prob=0.0), visual_dim=DV,
            acoustic_dim=DA)
    cfg = dataclasses.replace(JXLNetConfig.tiny(V), dropout=0.0,
                              summary_last_dropout=0.0)
    return jxlnet.MagXLNetForSequenceClassification(
        cfg, JMultimodalConfig(dropout_prob=0.0, injection_index=1),
        visual_dim=DV, acoustic_dim=DA)


def _jax_params(family):
    import jax

    jmodel = _jax_model(family)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  *BATCHES[0][:5])["params"]
    return jmodel, jax.device_get(params)


def _to_port(family, tree):
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
        xlnet_params_from_flax,
    )

    sd = (params_from_flax if family == "bert" else xlnet_params_from_flax)(
        tree)
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_trees():
    return {f: _jax_params(f) for f in ("bert", "xlnet")}


@pytest.fixture(scope="module")
def full_params(jax_trees):
    """The JAX params as port state dicts (numpy, so the ranks receive
    them pickled); XLNet's unused ``mask_emb``, which a tree initialised
    without ``target_mapping`` lacks, is the port's own."""
    out = {f: _to_port(f, tree) for f, (_, tree) in jax_trees.items()}
    out["xlnet"]["transformer.mask_emb"] = _model("xlnet").state_dict()[
        "transformer.mask_emb"].numpy()
    return out


def _jax_steps(jmodel, params, grad_accum=1):
    """The JAX one-device Trainer's two steps: (losses, params after)."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        MeshConfig as JMeshConfig,
    )
    from bert_multimodal_transformer_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )
    from bert_multimodal_transformer_tpu.training import optim as joptim
    from bert_multimodal_transformer_tpu.training import trainer as jtrainer

    jtr = jtrainer.Trainer(
        model=jmodel, tx=joptim.make_optimizer(LR, 4), donate=False,
        grad_accum=grad_accum,
        mesh=jmake_mesh(JMeshConfig(data_parallel=1),
                        devices=jax.devices()[:1]))
    st = jtr.create_state_from_params(params, jax.random.PRNGKey(1))
    losses = []
    for b in BATCHES:
        st, loss = jtr._train_step(st, jtr._put_batch(b))
        losses.append(float(loss))
    return losses, jax.device_get(st.params)


@pytest.fixture(scope="module")
def jax_runs(jax_trees, rank_runs):
    """{(family, grad_accum): (losses, port-named params)}; asks for the
    ranks first, so they run while JAX compiles."""
    out = {}
    for family, ga in (("bert", 1), ("bert", 2), ("xlnet", 1)):
        jmodel, tree = jax_trees[family]
        losses, params = _jax_steps(jmodel, tree, ga)
        out[family, ga] = (losses, _to_port(family, params))
    return out


# ---- what each rank runs ----------------------------------------------------


def _np(params_np):
    return {k: torch.from_numpy(v) for k, v in params_np.items()}


def _fsdp_rank(rank, model_parallel, params_np, tmp):
    """Every FSDP case of one mesh on this rank."""
    mesh = make_mesh(MeshConfig(data_parallel=-1,
                                model_parallel=model_parallel),
                     ["cpu"] * dist.get_world_size())
    bert, xlnet = _np(params_np["bert"]), _np(params_np["xlnet"])
    shard = model_parallel > 1
    out = {}
    for family, params in (("bert", bert), ("xlnet", xlnet)):
        model = _model(family, mesh=mesh if shard else None)
        out[family] = _steps(_trainer(model, mesh, True, shard=shard),
                             params)
    if shard:
        return out
    out["bert_ga2"] = _steps(_trainer(_model("bert"), mesh, True, 2), bert,
                             grad_accum=2)
    # the shards between steps: params and moments
    model = _model("bert")
    tr = _trainer(model, mesh, True)
    st = tr.create_state_from_params(bert, 1)
    tr._train_step(st, tr._put_batch(BATCHES[0]))
    w = model.bert.encoder.layer[0].intermediate_dense.weight
    out["shapes"] = (tuple(w.shape), tuple(
        st.optimizer.state[w]["exp_avg"].shape))
    out["replicated"] = (st.step, st.optimizer.count,
                         st.generator.get_state().numpy().tobytes())
    # the masked step, eval and predict
    loss = float(tr._train_step_masked(st, tr._put_batch(TAIL), TAIL_VALID))
    loader = [(BATCHES[1], np.ones(B, bool)), (TAIL, TAIL_VALID)]
    out["masked_eval_predict"] = (loss, tr.eval_epoch(st, loader),
                                  tr.test_epoch(st, loader)[0])
    # checkpoint: save after one step, then two more steps; a fresh trainer
    # restores and takes the same two steps
    model = _model("bert")
    tr = _trainer(model, mesh, True)
    st = tr.create_state_from_params(bert, 1)
    tr._train_step(st, tr._put_batch(BATCHES[0]))
    mgr = CheckpointManager(tmp)
    mgr.save(st, 1)
    cont = [float(tr._train_step(st, tr._put_batch(b))) for b in BATCHES]
    cont_params = {k: v.numpy() for k, v in
                   tp.full_state_dict(st.model).items()}
    model2 = _model("bert")
    tr2 = _trainer(model2, mesh, True)
    st2 = tr2.init_state(99)
    st2 = CheckpointManager(tmp).restore(st2, 1)
    again = [float(tr2._train_step(st2, tr2._put_batch(b)))
             for b in BATCHES]
    again_params = {k: v.numpy() for k, v in
                    tp.full_state_dict(st2.model).items()}
    saved = CheckpointManager(tmp).restore_params(1)
    out["resume"] = (cont, again, cont_params, again_params,
                     {k: tuple(v.shape) for k, v in saved.items()})
    # clipping reads the whole model's norm
    out["clipped"] = _steps(_trainer(_model("bert"), mesh, True,
                                     max_grad_norm=0.05), bert)
    return out


@pytest.fixture(scope="module")
def rank_runs(full_params, tmp_path_factory):
    """The 2×1 (data × model) and the 2×2 mesh's runs, started together in
    the background."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    tmp = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    runs = {f"2x{mp}": pool.submit(
        run_ranks, _fsdp_rank, 2 * mp, (mp, full_params, tmp),
        timeout_s=RANK_TIMEOUT_S, devices=["cpu"] * (2 * mp))
        for mp in (1, 2)}
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_process(full_params):
    """The port's one-process trainer on the same cases."""
    out = {}
    for family in ("bert", "xlnet"):
        out[family] = _steps(_trainer(_model(family)),
                             _np(full_params[family]))
    out["bert_ga2"] = _steps(_trainer(_model("bert"), grad_accum=2),
                             _np(full_params["bert"]), grad_accum=2)
    tr = _trainer(_model("bert"))
    st = tr.create_state_from_params(_np(full_params["bert"]), 1)
    tr._train_step(st, tr._put_batch(BATCHES[0]))
    loss = float(tr._train_step_masked(st, tr._put_batch(TAIL), TAIL_VALID))
    loader = [(BATCHES[1], np.ones(B, bool)), (TAIL, TAIL_VALID)]
    out["masked_eval_predict"] = (loss, tr.eval_epoch(st, loader),
                                  tr.test_epoch(st, loader)[0])
    out["clipped"] = _steps(_trainer(_model("bert"), max_grad_norm=0.05),
                            _np(full_params["bert"]))
    return out


def _close_params(got, want):
    """Every parameter of ``want`` (the JAX tree has no ``mask_emb``)."""
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


# ---- the rule ---------------------------------------------------------------


@pytest.mark.parametrize("shape,n,base", [
    ((32, 64), 8, None), ((64, 32), 8, None), ((64, 64), 8, None),
    ((30522,), 8, None), ((), 8, None), ((1,), 2, None), ((2,), 2, None),
    ((3, 5), 2, None), ((50, 768), 2, None), ((768, 768), 4, None),
    ((32, 64), 2, (None, "model")), ((32, 64), 2, ("model",)),
    ((2, 16, 8), 2, (None, "model", None)), ((64, 64), 2, ("model",)),
])
def test_fsdp_pspec_rule_matches_jax(shape, n, base):
    from bert_multimodal_transformer_tpu.parallel.fsdp import (
        fsdp_pspec_for_leaf as jax_rule,
    )

    assert fsdp.fsdp_pspec_for_leaf(shape, n, base) == tuple(
        jax_rule(shape, n, base))


def _fake_mesh(data, model):
    """A mesh of ``data`` × ``model`` seen from rank 0, with no process
    group (the rule reads only the axis sizes)."""
    return Mesh(data_size=data, model_size=model, rank=0,
                device=torch.device("cpu"), backend=None)


@pytest.mark.parametrize("family", ["bert", "xlnet"])
@pytest.mark.parametrize("model_parallel", [1, 2])
def test_fsdp_specs_shard_the_jax_leaves_elements(family, model_parallel,
                                                  jax_trees):
    """Every leaf's data rank 0 holds the same elements as the JAX
    ``make_fsdp_state_shardings`` gives it, through the port's names and
    layouts (the leaves filled with their element indices and carried
    over by ``params_from_flax``)."""
    import jax
    from jax.sharding import Mesh as JMesh

    from bert_multimodal_transformer_tpu.parallel.fsdp import (
        make_fsdp_state_shardings,
    )

    _, tree = jax_trees[family]
    indexed = jax.tree_util.tree_map(
        lambda x: np.arange(np.size(x), dtype=np.float64).reshape(
            np.shape(x)), tree)
    jmesh = JMesh(np.asarray(jax.devices()[:2 * model_parallel]).reshape(
        2, model_parallel), ("data", "model"))
    jspecs = make_fsdp_state_shardings(indexed, jmesh,
                                       shard_attention=model_parallel > 1)
    flat = jax.tree_util.tree_flatten_with_path(indexed)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda s: hasattr(s, "spec"))

    def data_half(arr, spec):
        spec = tuple(spec) + (None,) * (arr.ndim - len(spec))
        if "data" not in spec:
            return arr
        d = spec.index("data")
        return np.take(arr, range(arr.shape[d] // 2), axis=d)

    jax_half = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(indexed),
        [data_half(np.asarray(x), s.spec)
         for (_, x), s in zip(flat, spec_leaves)])
    want = _to_port(family, jax_half)
    full = _to_port(family, indexed)
    model = _model(family)
    specs = fsdp.make_fsdp_state_specs(
        model, _fake_mesh(2, model_parallel),
        shard_attention=model_parallel > 1)
    for name in full:
        got = data_half(full[name], specs[name])
        assert got.shape == want[name].shape, name
        assert np.array_equal(got, want[name]), name


# ---- the step ---------------------------------------------------------------


@pytest.mark.parametrize("family", ["bert", "xlnet"])
def test_fsdp_step_matches_jax_plain_step(family, rank_runs, jax_runs,
                                          one_process):
    """Two data ranks: the losses against the JAX one-device step and the
    port's one-process step, the updated params against JAX's."""
    got = rank_runs["2x1"].result()
    losses, params = got[0][family]
    np.testing.assert_allclose(losses, jax_runs[family, 1][0],
                               rtol=JAX_LOSS_RTOL)
    np.testing.assert_allclose(losses, one_process[family][0],
                               rtol=FSDP_LOSS_RTOL)
    _close_params(params, jax_runs[family, 1][1])
    assert got[1][family][0] == losses


def test_fsdp_grad_accum_fused_matches_jax(rank_runs, jax_runs, one_process):
    """grad_accum = 2 on the fused branch (the kernels' plain versions on
    the CPU) over two data ranks."""
    losses, params = rank_runs["2x1"].result()[0]["bert_ga2"]
    np.testing.assert_allclose(losses, jax_runs["bert", 2][0],
                               rtol=JAX_LOSS_RTOL)
    np.testing.assert_allclose(losses, one_process["bert_ga2"][0],
                               rtol=FSDP_LOSS_RTOL)
    _close_params(params, jax_runs["bert", 2][1])


@pytest.mark.parametrize("family", ["bert", "xlnet"])
def test_fsdp_tp_2x2_matches_jax(family, rank_runs, jax_runs):
    """FSDP × TP (head-sharded attention, fused) on a 2 × 2 mesh: the TP
    rules claim their dimension and FSDP the largest free one; every rank
    ends with the same full params."""
    ranks = rank_runs["2x2"].result()
    losses, params = ranks[0][family]
    np.testing.assert_allclose(losses, jax_runs[family, 1][0],
                               rtol=JAX_LOSS_RTOL)
    _close_params(params, jax_runs[family, 1][1])
    for r in ranks[1:]:
        assert r[family][0] == losses


def test_fsdp_masked_eval_predict_paths(rank_runs, one_process):
    loss, ev, preds = rank_runs["2x1"].result()[0]["masked_eval_predict"]
    ref = one_process["masked_eval_predict"]
    np.testing.assert_allclose(loss, ref[0], rtol=FSDP_LOSS_RTOL)
    np.testing.assert_allclose(ev, ref[1], rtol=FSDP_LOSS_RTOL)
    assert preds.shape == ref[2].shape == (B + 5,)
    np.testing.assert_allclose(preds, ref[2], rtol=1e-5, atol=1e-6)


def test_fsdp_checkpoint_resumes_bit_for_bit(rank_runs, full_params):
    """A restored FSDP state takes the same steps as the uninterrupted
    one, bit for bit; the checkpoint holds the full-size params."""
    cont, again, cont_p, again_p, saved = rank_runs["2x1"].result()[0][
        "resume"]
    assert cont == again
    assert all(np.array_equal(cont_p[k], again_p[k]) for k in cont_p)
    assert saved == {k: v.shape for k, v in full_params["bert"].items()}


def test_fsdp_keeps_slices_between_steps(rank_runs):
    """intermediate_dense's weight [64, 32] (the JAX kernel [32, 64]
    shards its 64 outputs) and its moment hold half on each data rank."""
    assert rank_runs["2x1"].result()[0]["shapes"] == ((32, 32), (32, 32))


def test_fsdp_step_and_rng_replicated(rank_runs):
    """The step count, the optimizer's update count and the dropout
    generator stay whole and equal on every rank (JAX replicates
    ``.step`` and ``.rng``)."""
    ranks = rank_runs["2x1"].result()
    assert ranks[0]["replicated"][:2] == (1, 1)
    assert ranks[0]["replicated"] == ranks[1]["replicated"]


def test_fsdp_clips_by_the_whole_models_norm(rank_runs, one_process):
    """max_grad_norm: the norm sums every data rank's slices, so the
    clipped step equals the one-process clipped step."""
    losses, params = rank_runs["2x1"].result()[0]["clipped"]
    ref_losses, ref_params = one_process["clipped"]
    np.testing.assert_allclose(losses, ref_losses, rtol=FSDP_LOSS_RTOL)
    _close_params(params, ref_params)
    unclipped = one_process["bert"][1]
    assert any(not np.allclose(ref_params[k], unclipped[k]) for k in
               ref_params)


def test_fsdp_refuses_mem_len():
    """The JAX trainer's refusal of the memory under FSDP."""
    model = _model("xlnet")
    model.config = dataclasses.replace(model.config, mem_len=4)
    with pytest.raises(ValueError, match="mem_len supports the "
                       "data-parallel trainer"):
        ttr.Trainer(model=model, tx=toptim.make_optimizer(LR, 1),
                    fsdp=True, mem_len=4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_resume.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
