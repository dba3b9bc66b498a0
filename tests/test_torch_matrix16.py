"""The 16-place parallelism matrix on the port, the contract of JAX
``tests/test_parallel_matrix16.py`` (``__graft_entry__._dryrun_matrix16``),
held against the JAX package.

One spawn of 16 CPU ranks over gloo (``parallel/mesh.py::run_ranks``,
under a timeout of its own, run in the background while JAX compiles)
builds, in turn, each mesh in the same group at the JAX function's shapes
(``BertConfig.tiny(vocab 128)``, B=32, S=16, dv 5, da 7), and runs one
dropout-0 step from the JAX model's weights (``utils/convert.py``):

* FSDP × TP × DP on an 8 × 2 mesh (MAG-BERT, ``Trainer(fsdp=True)``: the
  data axis carries the batch shards and the parameter shards);
* a 4-stage GPipe × 4-way data mesh, one layer a stage, for MAG-BERT and
  MAG-XLNet (injection_index 1 with k = 1: MAG on stage 1);
* the 3-D point, 4 stages × 2-way TP × 2-way data, for both families.

Each rank's loss and its part of every gradient equal the JAX one-device
``Trainer`` step's (for the pipelines ``Trainer(grad_accum=4)``) within
``chip_smoke.py``'s ``PAR_FP32_TOL``: the loss within 1e-6 relative, each
gradient within 1e-5 of its leaf's largest magnitude. The JAX step's
gradients are read from its AdamW state: one step from zero moments
leaves ``mu = (1 − b1)·g``. The negative cases of the JAX file: an
indivisible mesh, a pipe overcommit, a local batch that does not divide
into the microbatches, layers that do not divide over the stages; each
fails with the JAX message.
"""

import concurrent.futures
import dataclasses
import pickle

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
from bert_multimodal_transformer_tpu_torch.parallel import tp
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_pp_mesh,
    run_ranks,
)
from bert_multimodal_transformer_tpu_torch.parallel.pp import (
    PipelineTrainer,
)
from bert_multimodal_transformer_tpu_torch.parallel.pp_xlnet import (
    XLNetPipelineTrainer,
)
from bert_multimodal_transformer_tpu_torch.training.optim import (
    make_optimizer,
)
from bert_multimodal_transformer_tpu_torch.training.trainer import Trainer

DV, DA, V, S, B = 5, 7, 128, 16, 32
WORLD = 16
N_MICRO = 4
LR, B1 = 1e-3, 0.9
RANK_TIMEOUT_S = 300
PAR_FP32_TOL = {"loss": 1e-6, "grad": 1e-5}
# (case, family, stages, data, model): FSDP×TP first, then the pipelines
CASES = (("fsdp8 x tp2", "bert", 0, 8, 2),
         ("pp4 x dp4", "bert", 4, 4, 1),
         ("pp4 x dp4", "xlnet", 4, 4, 1),
         ("pp4 x tp2 x dp2", "bert", 4, 2, 2),
         ("pp4 x tp2 x dp2", "xlnet", 4, 2, 2))


def _reference(family, stages):
    """The JAX step a case is held against: (family, layers, grad_accum)."""
    return (family, 4, N_MICRO) if stages else (family, 2, 1)


REFERENCES = sorted({_reference(c[1], c[2]) for c in CASES})


def _batch(family):
    r = np.random.RandomState(16)
    lengths = r.randint(4, S + 1, B)
    lengths[-1] = S
    pos = np.arange(S)[None, ::-1] if family == "xlnet" else np.arange(S)
    mask = (pos < lengths[:, None]).astype(np.int32)
    seg = ((np.arange(S)[None, :] >= S // 2).astype(np.int32).repeat(B, 0)
           if family == "xlnet" else np.zeros((B, S), np.int32))
    return (r.randint(1, V, (B, S)).astype(np.int32) * mask,
            r.randn(B, S, DV).astype(np.float32),
            r.randn(B, S, DA).astype(np.float32), mask, seg,
            r.randn(B).astype(np.float32))


def _model(family, n_layers):
    """The JAX function's tiny model at dropout 0."""
    if family == "xlnet":
        cfg = dataclasses.replace(XLNetConfig.tiny(V), n_layer=n_layers,
                                  dropout=0.0, summary_last_dropout=0.0)
        return MagXLNetForSequenceClassification(
            cfg, MultimodalConfig(1.0, 0.0, injection_index=1), DV, DA,
            device="cpu")
    cfg = dataclasses.replace(BertConfig.tiny(V), num_hidden_layers=n_layers,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    return MagBertForSequenceClassification(
        cfg, MultimodalConfig(1.0, 0.0), DV, DA, device="cpu")


def _tx():
    return make_optimizer(LR, 10, warmup_proportion=0.0)


# ---- the JAX side -----------------------------------------------------------


def _jax_model(family, n_layers):
    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MultimodalConfig as JMultimodalConfig,
        XLNetConfig as JXLNetConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert
    from bert_multimodal_transformer_tpu.models import xlnet as jxlnet

    if family == "xlnet":
        cfg = dataclasses.replace(JXLNetConfig.tiny(V), n_layer=n_layers,
                                  dropout=0.0, summary_last_dropout=0.0)
        return jxlnet.MagXLNetForSequenceClassification(
            cfg, JMultimodalConfig(1.0, 0.0, injection_index=1),
            visual_dim=DV, acoustic_dim=DA)
    cfg = dataclasses.replace(JBertConfig.tiny(V),
                              num_hidden_layers=n_layers,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    return jbert.MagBertForSequenceClassification(
        cfg, JMultimodalConfig(1.0, 0.0), visual_dim=DV, acoustic_dim=DA)


def _to_port(family, tree):
    """A JAX params (or gradients) tree as a port state dict of arrays."""
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
        xlnet_params_from_flax,
    )

    convert = xlnet_params_from_flax if family == "xlnet" else \
        params_from_flax
    return {k: v.numpy().copy() for k, v in convert(tree).items()}


def _jax_init(ref):
    import jax

    jmodel = _jax_model(*ref[:2])
    return jmodel, jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *_batch(ref[0])[:5])["params"])


@pytest.fixture(scope="module")
def jax_inits():
    """{reference: (JAX model, its params from PRNGKey(0))}, the inits
    compiled in threads."""
    with concurrent.futures.ThreadPoolExecutor(len(REFERENCES)) as pool:
        return dict(zip(REFERENCES, pool.map(_jax_init, REFERENCES)))


@pytest.fixture(scope="module")
def full_params(jax_inits):
    """{reference: the JAX params as a port state dict}, XLNet's with the
    port's own ``mask_emb`` (a tree initialised without
    ``target_mapping`` has none; no step reads it)."""
    out = {}
    for ref, (_, tree) in jax_inits.items():
        out[ref] = _to_port(ref[0], tree)
        if ref[0] == "xlnet":
            out[ref]["transformer.mask_emb"] = _model(*ref[:2]).state_dict()[
                "transformer.mask_emb"].numpy()
    return out


def _jax_step(ref, jmodel, tree):
    """The JAX one-device ``Trainer(grad_accum)`` step: (loss, its
    gradients as a port state dict)."""
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
        model=jmodel, donate=False, grad_accum=ref[2],
        tx=joptim.make_optimizer(LR, 10, warmup_proportion=0.0, b1=B1),
        mesh=jmake_mesh(JMeshConfig(data_parallel=1),
                        devices=jax.devices()[:1]))
    st = jtr.create_state_from_params(tree, jax.random.PRNGKey(1))
    st, loss = jtr._train_step(st, jtr._put_batch(_batch(ref[0])))
    mu = jax.device_get(st.opt_state[0].mu)
    grads = jax.tree_util.tree_map(lambda m: m / np.float32(1.0 - B1), mu)
    return float(loss), _to_port(ref[0], grads)


@pytest.fixture(scope="module")
def jax_steps(jax_inits, rank_runs):
    """{reference: the JAX step's (loss, gradients)}; asks for the ranks
    first, so they run while JAX compiles (the programs in threads)."""
    with concurrent.futures.ThreadPoolExecutor(len(REFERENCES)) as pool:
        done = {ref: pool.submit(_jax_step, ref, *jax_inits[ref])
                for ref in REFERENCES}
        return {ref: fut.result() for ref, fut in done.items()}


# ---- what each rank runs ----------------------------------------------------


def _part(p, full, name, mesh):
    """This rank's part of a full-size tensor: its model-axis chunk, then
    its data-axis shard under FSDP."""
    full = tp.shard_tensor(full, tp.tp_pspec_for_path(name), mesh)
    shard = getattr(p, "fsdp_shard", None)
    if shard is not None:
        n = full.shape[shard[0]] // mesh.data_size
        full = full.narrow(shard[0], mesh.data_rank * n, n)
    return full


def _matrix_rank(rank, params_file):
    """Every case's step on this rank: (loss, {model name: (its gradient,
    the flat indices of its elements in the full leaf)}, pipe rank)."""
    torch.set_num_threads(1)
    with open(params_file, "rb") as f:
        params_np = pickle.load(f)
    world = ["cpu"] * dist.get_world_size()
    out = []
    for case, family, stages, dp, mp in CASES:
        ref = _reference(family, stages)
        if stages:
            mesh = make_pp_mesh(stages, data_parallel=dp, model_parallel=mp,
                                devices=world)
            cls = (XLNetPipelineTrainer if family == "xlnet"
                   else PipelineTrainer)
            tr = cls(model=_model(*ref[:2]), tx=_tx(), mesh=mesh,
                     n_micro=N_MICRO)
        else:
            mesh = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp),
                             world)
            tr = Trainer(model=_model(*ref[:2]), tx=_tx(), mesh=mesh,
                         fsdp=True)
        full = {k: torch.from_numpy(v) for k, v in params_np[ref].items()}
        st = tr.create_state_from_params(full, 1)
        loss = float(tr._train_step(st, tr._put_batch(_batch(family))))
        names = (st.model.model_names() if hasattr(st.model, "model_names")
                 else {n: n for n, _ in st.model.named_parameters()})
        # AdamW leaves the gradients: these are the step's
        grads = {}
        for n, p in st.model.named_parameters():
            if p.grad is not None:
                name = names[n]
                flat = torch.arange(full[name].numel(), dtype=torch.int32)
                idx = _part(p, flat.view(full[name].shape), name, mesh)
                grads[name] = (p.grad.numpy().copy(), idx.numpy().copy())
        out.append((loss, grads, mesh.pipe_rank))
    return out


@pytest.fixture(scope="module")
def rank_runs(full_params, tmp_path_factory):
    """The 16 ranks' results (a future). The params go by file: a large
    argument would be written to each spawned rank in turn, as it
    starts."""
    params_file = tmp_path_factory.mktemp("matrix16") / "params.pkl"
    with open(params_file, "wb") as f:
        pickle.dump(full_params, f)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(run_ranks, _matrix_rank, WORLD, (str(params_file),),
                      timeout_s=RANK_TIMEOUT_S, devices=["cpu"] * WORLD)
    pool.shutdown(wait=True)


def _gap(got, want, scale):
    """max |got − want| over the leaf's ``scale`` (its largest magnitude;
    the max |Δ| when that is 0). A shard's own largest magnitude is no
    scale: an 8-way shard of the packed qkv bias can hold only key
    biases, whose gradient is rounding noise (softmax ignores them)."""
    d = float(np.abs(got - want).max())
    return d / scale if scale > 0 else d


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_matrix16_step_equals_the_plain_step(i, rank_runs, jax_steps):
    """Every rank's loss and gradients against the JAX one-device step;
    every leaf holds a gradient on some rank (layers on their stage
    only)."""
    ranks = rank_runs.result()
    case, family, stages = CASES[i][:3]
    want_loss, want_grads = jax_steps[_reference(family, stages)]
    seen = set()
    for r in ranks:
        loss, grads, _ = r[i]
        assert abs(loss - want_loss) <= PAR_FP32_TOL["loss"] * abs(want_loss)
        gaps = {n: _gap(g, want_grads[n].reshape(-1)[idx],
                        float(np.abs(want_grads[n]).max()))
                for n, (g, idx) in grads.items()}
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= PAR_FP32_TOL["grad"], (worst, gaps[worst])
        seen |= set(gaps)
    assert seen == set(want_grads)
    if stages:
        # each stage holds its one layer's gradients and no other's
        prefix = ("transformer.layer." if family == "xlnet"
                  else "bert.encoder.layer.")
        for r in ranks:
            layers = {n[len(prefix):].split(".")[0] for n in r[i][1]
                      if n.startswith(prefix)}
            assert layers == {str(r[i][2])}


# ---- negative cases ---------------------------------------------------------


def test_mesh_indivisible_errors():
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(MeshConfig(data_parallel=-1, model_parallel=3),
                  ["cpu"] * 8)
    with pytest.raises(ValueError, match="needs more than"):
        make_mesh(MeshConfig(data_parallel=8, model_parallel=2), ["cpu"] * 8)
    with pytest.raises(ValueError, match="data axis"):
        make_mesh(MeshConfig(data_parallel=0, model_parallel=2), ["cpu"] * 8)


def test_pp_mesh_overcommit_errors():
    with pytest.raises(ValueError, match="needs"):
        make_pp_mesh(8, data_parallel=2, devices=["cpu"] * 8)


def _pp_mesh(stages, data=1):
    """A (data, stages, 1) pipeline mesh seen from rank 0, with no process
    group (the checks below run before any collective)."""
    return Mesh(data_size=data, model_size=1, rank=0,
                device=torch.device("cpu"), backend=None, pipe_size=stages,
                pipelined=True)


def test_pp_microbatch_indivisible_errors():
    """A local batch that does not divide by n_micro fails loudly, not by
    truncating examples."""
    model = MagBertForSequenceClassification(
        dataclasses.replace(BertConfig.tiny(97), num_hidden_layers=2),
        MultimodalConfig(1.0, 0.0), 3, 4, device="cpu")
    pt = PipelineTrainer(model=model, tx=_tx(), mesh=_pp_mesh(2), n_micro=4)
    r = np.random.RandomState(0)
    bad = (r.randint(0, 97, (6, 8)).astype(np.int32),      # 6 % 4 != 0
           r.randn(6, 8, 3).astype(np.float32),
           r.randn(6, 8, 4).astype(np.float32),
           np.ones((6, 8), np.int32), np.zeros((6, 8), np.int32),
           r.randn(6).astype(np.float32))
    state = pt.init_state(0)
    with pytest.raises(ValueError, match="not divisible by n_micro"):
        pt.train_step(state, bad)


def test_uneven_layers_per_stage_errors():
    mesh = _pp_mesh(4, data=2)
    with pytest.raises(ValueError, match="divide evenly"):
        PipelineTrainer(
            model=MagBertForSequenceClassification(
                dataclasses.replace(BertConfig.tiny(), num_hidden_layers=6),
                MultimodalConfig(1.0, 0.0), 3, 4, device="cpu"),
            tx=_tx(), mesh=mesh, n_micro=2)
    with pytest.raises(ValueError, match="divide evenly"):
        XLNetPipelineTrainer(
            model=MagXLNetForSequenceClassification(
                dataclasses.replace(XLNetConfig.tiny(), n_layer=6),
                MultimodalConfig(1.0, 0.0, injection_index=1), 3, 4,
                device="cpu"),
            tx=_tx(), mesh=mesh, n_micro=2)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_resume.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
