"""The port's GPipe pipeline for MAG-XLNet (``parallel/pp_xlnet.py``,
``XLNetPipelineTrainer``) against the JAX package, carrying the contracts
of ``tests/test_pp_xlnet.py``.

Both injection geometries of JAX ``tests/test_pp_xlnet.py:91``: k ≥ 2 (4
layers over 2 stages, MAG before layer 1 inside stage 0) and k = 1 (2
layers over 2 stages, MAG on stage 1 before its only layer). The ranks
are CPU processes over gloo (``parallel/mesh.py::run_ranks``, each mesh's
cases in one spawn under a timeout of their own, in the background while
JAX compiles): k = 2 on (2 stages, dp 1), k = 1 on (2 stages, dp 2), and
PP×TP (2 stages × 2 model) at k = 2, at n_micro 2, dropout 0, fp32, from
the JAX model's weights, against the JAX one-device
``Trainer(grad_accum=2)`` step. Also: MAG runs on the injection's stage
only, predict against the model's forward, the pipeline layout against
the JAX one, dropout replay, and the refusals (``attn_type``, ``bi_data``,
an injection outside the stack, the FFN split).

Tolerances are the JAX tests': the loss rtol 1e-5 atol 1e-6, params rtol
2e-5 atol 1e-6.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch.config import (
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.models.xlnet import (
    MagXLNetForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.parallel import pp
from bert_multimodal_transformer_tpu_torch.parallel import pp_xlnet
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    make_pp_mesh,
    run_ranks,
)
from bert_multimodal_transformer_tpu_torch.training import optim as toptim

VIS, AC, V, S, B = 5, 7, 97, 10, 16
N_MICRO = 2
INJ = 1
LR = 1e-3
RANK_TIMEOUT_S = 240
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6
# (layers, stages, dp, mp): the cases each spawn runs
GEOMETRIES = {"k2": (4, 2, 1, 1), "k1-dp2": (2, 2, 2, 1),
              "k2-mp2": (4, 2, 1, 2)}


def _batch(seed, b=B):
    r = np.random.RandomState(seed)
    lengths = r.randint(3, S + 1, b)
    lengths[-1] = S
    # XLNet pads on the left
    mask = (np.arange(S)[None, ::-1] < lengths[:, None]).astype(np.int32)
    seg = (np.arange(S)[None, :] >= S // 2).astype(np.int32).repeat(b, 0)
    return (r.randint(1, V, (b, S)).astype(np.int32) * mask,
            r.randn(b, S, VIS).astype(np.float32),
            r.randn(b, S, AC).astype(np.float32), mask, seg,
            r.randn(b).astype(np.float32))


BATCH = _batch(0)


def _cfg(n_layer, rate=0.0, **kw):
    return dataclasses.replace(
        XLNetConfig.tiny(V), **{"n_layer": n_layer, "attention_impl": "fused",
                                "dropout": rate,
                                "summary_last_dropout": rate, **kw})


def _model(n_layer, rate=0.0, inj=INJ, **kw):
    return MagXLNetForSequenceClassification(
        _cfg(n_layer, rate, **kw),
        MultimodalConfig(dropout_prob=rate, injection_index=inj), VIS, AC,
        device="cpu")


def _tx():
    # no warmup: the first step moves the params
    return toptim.make_optimizer(LR, 10, warmup_proportion=0.0)


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


# ---- the JAX side -----------------------------------------------------------


def _jax_model(n_layer):
    from bert_multimodal_transformer_tpu.config import (
        MultimodalConfig as JMultimodalConfig,
        XLNetConfig as JXLNetConfig,
    )
    from bert_multimodal_transformer_tpu.models import xlnet as jxlnet

    cfg = dataclasses.replace(JXLNetConfig.tiny(V), n_layer=n_layer,
                              dropout=0.0, summary_last_dropout=0.0)
    return jxlnet.MagXLNetForSequenceClassification(
        cfg, JMultimodalConfig(dropout_prob=0.0, injection_index=INJ),
        visual_dim=VIS, acoustic_dim=AC)


@pytest.fixture(scope="module")
def jax_trees():
    """{n_layer: (JAX model, its params from PRNGKey(0))}."""
    import jax

    out = {}
    for n_layer in (2, 4):
        jmodel = _jax_model(n_layer)
        out[n_layer] = (jmodel, jax.device_get(jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), *BATCH[:5])["params"]))
    return out


def _to_port(tree):
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    return _np(xlnet_params_from_flax(tree))


@pytest.fixture(scope="module")
def full_params(jax_trees):
    """{n_layer: the JAX params as a port state dict}, with the port's
    own ``mask_emb`` (a tree initialised without ``target_mapping`` has
    none)."""
    out = {}
    for n_layer, (_, tree) in jax_trees.items():
        out[n_layer] = _to_port(tree)
        out[n_layer]["transformer.mask_emb"] = _model(n_layer).state_dict()[
            "transformer.mask_emb"].numpy()
    return out


@pytest.fixture(scope="module")
def jax_steps(jax_trees, rank_runs):
    """{n_layer: the JAX plain grad_accum=2 step's (loss, params)}; asks
    for the ranks first, so they run while JAX compiles."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        MeshConfig as JMeshConfig,
    )
    from bert_multimodal_transformer_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )
    from bert_multimodal_transformer_tpu.training import optim as joptim
    from bert_multimodal_transformer_tpu.training import trainer as jtrainer

    out = {}
    for n_layer, (jmodel, tree) in jax_trees.items():
        jtr = jtrainer.Trainer(
            model=jmodel, donate=False, grad_accum=N_MICRO,
            tx=joptim.make_optimizer(LR, 10, warmup_proportion=0.0),
            mesh=jmake_mesh(JMeshConfig(data_parallel=1),
                            devices=jax.devices()[:1]))
        st = jtr.create_state_from_params(tree, jax.random.PRNGKey(1))
        st, loss = jtr._train_step(st, jtr._put_batch(BATCH))
        out[n_layer] = (float(loss), _to_port(jax.device_get(st.params)))
    return out


# ---- what each rank runs ----------------------------------------------------


def _trainer(mesh, n_layer, rate=0.0):
    return pp_xlnet.XLNetPipelineTrainer(model=_model(n_layer, rate),
                                         tx=_tx(), mesh=mesh,
                                         n_micro=N_MICRO)


def _pp_rank(rank, n_layer, stages, dp, mp, params_np):
    """Every case of one (data, pipe, model) mesh on this rank."""
    mesh = make_pp_mesh(stages, data_parallel=dp, model_parallel=mp,
                        devices=["cpu"] * dist.get_world_size())
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    out = {"pipe_rank": mesh.pipe_rank}
    tr = _trainer(mesh, n_layer)
    st = tr.create_state_from_params(params, 1)
    calls = []
    st.model.prologue.MAG.register_forward_hook(
        lambda *_: calls.append(1))
    out["loss"] = float(tr.train_step(st, BATCH))
    out["mag_calls"] = len(calls)
    out["params"] = _np(tr.model_params(st))
    out["predict"] = tr.predict(st, _batch(2)).numpy()
    if (dp, mp) == (1, 1):
        runs = []
        for _ in range(2):
            tr = _trainer(mesh, n_layer, rate=0.1)
            st = tr.create_state_from_params(params, 5)
            runs.append((float(tr.train_step(st, BATCH)),
                         _np(tr.model_params(st))))
        out["dropout"] = runs
    return out


@pytest.fixture(scope="module")
def rank_runs(full_params):
    pool = concurrent.futures.ThreadPoolExecutor(3)
    runs = {name: pool.submit(
        run_ranks, _pp_rank, stages * dp * mp,
        (n_layer, stages, dp, mp, full_params[n_layer]),
        timeout_s=RANK_TIMEOUT_S, devices=["cpu"] * (stages * dp * mp))
        for name, (n_layer, stages, dp, mp) in GEOMETRIES.items()}
    yield runs
    pool.shutdown(wait=True)


def _close_params(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


# ---- the tests --------------------------------------------------------------


@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_xlnet_pp_step_matches_jax_plain_grad_accum_step(geo, rank_runs,
                                                         jax_steps):
    """k = 2 (MAG inside stage 0), k = 1 over two data ranks (MAG on
    stage 1), and PP×TP: the loss on every rank and the stepped params
    against the JAX plain step."""
    n_layer = GEOMETRIES[geo][0]
    ranks = rank_runs[geo].result()
    ref_loss, ref_params = jax_steps[n_layer]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
    _close_params(ranks[0]["params"], ref_params)


@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_xlnet_pp_mag_runs_on_the_injection_stage_only(geo, rank_runs):
    """injection_index 1 = r0·k + p: stage r0 = 1 // k applies MAG once a
    microbatch, no other stage runs it."""
    n_layer, stages = GEOMETRIES[geo][:2]
    r0 = INJ // (n_layer // stages)
    for r in rank_runs[geo].result():
        want = N_MICRO if r["pipe_rank"] == r0 else 0
        assert r["mag_calls"] == want, (r["pipe_rank"], r["mag_calls"])


@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_xlnet_pp_predict_matches_model_forward(geo, rank_runs):
    n_layer = GEOMETRIES[geo][0]
    for r in rank_runs[geo].result():
        model = _model(n_layer)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in r["params"].items()})
        with torch.no_grad():
            b = [torch.from_numpy(a) for a in _batch(2)]
            want = model(*b[:3], attention_mask=b[3],
                         token_type_ids=b[4]).reshape(-1).numpy()
        np.testing.assert_allclose(r["predict"], want, rtol=1e-5,
                                   atol=1e-6)


def test_xlnet_pp_params_roundtrip_and_jax_layout(jax_trees, full_params):
    """The XLNet pipeline layout round-trips exactly, stacks what the JAX
    one stacks, and ``xlnet_params_from_flax`` takes the JAX layout."""
    from bert_multimodal_transformer_tpu.parallel.pp_xlnet import (
        pp_params_from_xlnet_params as jax_to_pp,
    )
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    sd = {k: torch.from_numpy(v) for k, v in full_params[4].items()}
    layout = pp_xlnet.pp_params_from_xlnet_params(sd)
    assert "prologue.mask_emb" in layout
    back = pp_xlnet.xlnet_params_from_pp_params(layout)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    jpp = jax_to_pp(jax_trees[4][1])
    np.testing.assert_array_equal(
        layout["layers.rel_attn.q"].numpy(),
        np.asarray(jpp["layers"]["rel_attn"]["q"]))
    np.testing.assert_array_equal(
        layout["layers.ff.layer_1.weight"].numpy(),
        np.swapaxes(np.asarray(jpp["layers"]["ff"]["layer_1"]["kernel"]),
                    1, 2))
    from_pp = xlnet_params_from_flax(jpp)
    assert set(from_pp) == set(sd) - {"transformer.mask_emb"}
    assert all(torch.equal(from_pp[k], sd[k]) for k in from_pp)


def test_xlnet_pp_dropout_moves_the_step_and_replays(rank_runs, jax_steps):
    (l1, p1), (l2, p2) = rank_runs["k2"].result()[0]["dropout"]
    assert l1 == l2
    assert all(np.array_equal(p1[k], p2[k]) for k in p1)
    assert np.isfinite(l1) and l1 != jax_steps[4][0]


def _pp_mesh(stages=2, model=1):
    return Mesh(data_size=1, model_size=model, rank=0,
                device=torch.device("cpu"), backend=None, pipe_size=stages,
                pipelined=True)


@pytest.mark.parametrize("model_kw,inj,mesh_kw,match", [
    ({"attn_type": "uni"}, INJ, {}, "attn_type='uni' is not pipelined"),
    ({"bi_data": True}, INJ, {}, "bi_data position streams are not"),
    ({}, 9, {}, r"injection_index 9 outside \[0, 4\)"),
    ({}, -1, {}, r"injection_index -1 outside \[0, 4\)"),
    ({"n_layer": 3}, INJ, {}, "divide evenly over 2 pipeline stages"),
    ({"d_inner": 66}, INJ, {"model": 4}, r"d_inner \(66\) must divide"),
], ids=["attn_type", "bi_data", "injection_past", "injection_negative",
        "layers", "ffn_split"])
def test_xlnet_pp_refusals(model_kw, inj, mesh_kw, match):
    kw = {"n_layer": 4, **model_kw}
    model = _model(kw.pop("n_layer"), inj=inj, **kw)
    with pytest.raises(ValueError, match=match):
        pp_xlnet.XLNetPipelineTrainer(model=model, tx=_tx(),
                                      mesh=_pp_mesh(**mesh_kw), n_micro=2)


def test_xlnet_pp_layout_names_the_family():
    """``pp_params_from_model_params`` reads the family off the names, so
    the BERT and XLNet names of the layout functions are one function."""
    assert pp_xlnet.pp_params_from_xlnet_params is (
        pp.pp_params_from_model_params)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_resume.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
