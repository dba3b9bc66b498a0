"""The GPipe pipeline under ``rng_impl="threefry2x32"`` against the JAX
``PipelineTrainer`` / ``XLNetPipelineTrainer`` under
``jax_default_prng_impl = "threefry2x32"``, dropout 0.1, einsum attention,
fp32, tiny configs of four layers.

The JAX steps run on the conftest's 8-device virtual CPU mesh; the port's
ranks are CPU processes over gloo (``parallel/mesh.py::run_ranks``, each
mesh's cases in one spawn under a timeout of its own, started before the
JAX side compiles). At (pipe, data, model) = (2, 1, 1), (2, 2, 1) and
(2, 1, 2), for MAG-BERT and MAG-XLNet:

* the init params (``init_state(seed)``: ``model.init(PRNGKey(seed))``)
  are the one-device threefry init's bit for bit, and JAX's within the
  normal initializer's ``NORMAL_RTOL``;
* two train steps and one masked step equal JAX's within the parallel
  band of ``tests/test_torch_threefry_parallel.py`` (losses rtol 1e-6,
  params rtol 1e-5 / atol 1e-7): every mask is JAX's, only the order of
  fp32 sums differs;
* the fused BERT step's kernel seeds are JAX's ``randint`` of each layer's
  ``attention`` key (the plain kernels, ``draw_seed`` recorded);
* planted faults leave the band: the layer key folded with the local
  index, XLNet's position mask drawn as a ``Dropout_0`` site, and at
  (2, 1, 2) XLNet's inner FFN mask drawn at full width and sliced;
* a threefry pipelined driver run resumed mid-epoch ends at the
  uninterrupted run's state bit for bit, and a resume under rbg is
  refused.
"""

import concurrent.futures
import dataclasses
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.models.bert import (
    MagBertForSequenceClassification,
    _hidden_dropout,
)
from bert_multimodal_transformer_tpu_torch.models.xlnet import (
    MagXLNetForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.ops.dropout import (
    SiteKey,
    ThreefryRngs,
    dropout,
)
from bert_multimodal_transformer_tpu_torch.parallel import pp, pp_xlnet
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    make_pp_mesh,
    run_ranks,
)
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttr
from bert_multimodal_transformer_tpu_torch.utils import jax_random
from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
    TRAIN_STATE_FILE,
    CheckpointManager,
)

DV, DA, V, S, B, L = 5, 7, 64, 10, 16, 4
N_MICRO, INJ = 2, 1
LR, RATE, SEED = 1e-3, 0.1, 7
RANK_TIMEOUT_S = 240
LOSS_RTOL = 1e-6
NORMAL_RTOL = 2e-6   # tests/test_torch_threefry.py: jax_random.normal
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7
GEOMETRIES = ((2, 1, 1), (2, 2, 1), (2, 1, 2))
FAMILIES = ("bert", "xlnet")
FAULTS = {"bert": "local layer index", "xlnet": "pos_emb as Dropout_0"}
TP_FAULT = "FFN mask at full width"


def _batch(seed, family, b=B):
    r = np.random.RandomState(seed)
    lengths = r.randint(3, S + 1, b)
    lengths[-1] = S
    pos = np.arange(S)[None, ::-1] if family == "xlnet" else np.arange(S)
    mask = (pos < lengths[:, None]).astype(np.int32)
    seg = ((np.arange(S)[None, :] >= S // 2).astype(np.int32).repeat(b, 0)
           if family == "xlnet" else np.zeros((b, S), np.int32))
    return (r.randint(1, V, (b, S)).astype(np.int32) * mask,
            r.randn(b, S, DV).astype(np.float32),
            r.randn(b, S, DA).astype(np.float32), mask, seg,
            r.randn(b).astype(np.float32))


TAIL_VALID = np.arange(B) < 11


def _batches(family):
    tail = tuple(np.where(TAIL_VALID.reshape((B,) + (1,) * (a.ndim - 1)),
                          a, 0).astype(a.dtype)
                 for a in _batch(2, family))
    return _batch(0, family), _batch(1, family), tail


def _model(family, impl="einsum"):
    mm = MultimodalConfig(dropout_prob=RATE,
                          injection_index=INJ if family == "xlnet" else 0)
    if family == "xlnet":
        cfg = dataclasses.replace(XLNetConfig.tiny(V), n_layer=L,
                                  dropout=RATE, summary_last_dropout=RATE,
                                  attention_impl=impl)
        return MagXLNetForSequenceClassification(cfg, mm, DV, DA,
                                                 device="cpu")
    cfg = dataclasses.replace(BertConfig.tiny(V), num_hidden_layers=L,
                              hidden_dropout_prob=RATE,
                              attention_probs_dropout_prob=RATE,
                              attention_impl=impl)
    return MagBertForSequenceClassification(cfg, mm, DV, DA, device="cpu")


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


# ---- what each rank runs ----------------------------------------------------


def _trainer(family, mesh, impl="einsum"):
    cls = (pp_xlnet.XLNetPipelineTrainer if family == "xlnet"
           else pp.PipelineTrainer)
    return cls(model=_model(family, impl), mesh=mesh, n_micro=N_MICRO,
               rng_impl="threefry2x32",
               tx=toptim.make_optimizer(LR, 10, warmup_proportion=0.0))


def _two_steps(tr):
    """(losses, params) of two train steps from ``init_state(SEED)``."""
    st = tr.init_state(SEED)
    family = "xlnet" if isinstance(tr, pp_xlnet.XLNetPipelineTrainer) \
        else "bert"
    losses = [float(tr.train_step(st, b)) for b in _batches(family)[:2]]
    return {"losses": losses, "params2": _np(tr.model_params(st))}


def _faults(family, mesh):
    """Each planted fault's two train steps."""
    if family == "bert":
        cls, name, attr = pp.PipelineTrainer, FAULTS["bert"], "_layer_rngs"
        fault = lambda self, rngs, j: pp._part(rngs, j)  # noqa: E731
    elif mesh.model_size == 1:
        cls, name = pp_xlnet.XLNetPipelineTrainer, FAULTS["xlnet"]
        attr = "_pos_emb_dropout"
        fault = lambda self, pos, rngs, det: _hidden_dropout(  # noqa: E731
            pos, RATE, pp._part(rngs, pp.PROLOGUE_TAG), det, "Dropout_0",
            batch=False)
    else:
        cls, name, attr = pp.PartRngs, TP_FAULT, "part"
        fault = lambda self, tag: ThreefryRngs.from_key(  # noqa: E731
            jax_random.fold_in(self.key, tag))
    right = getattr(cls, attr)
    setattr(cls, attr, fault)
    try:
        return {name: _two_steps(_trainer(family, mesh))}
    finally:
        setattr(cls, attr, right)


def _kernel_seeds(mesh):
    """The fused BERT step's kernel seeds on this stage, in call order."""
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as tfa,
    )

    seeds, real = [], tfa.draw_seed

    def draw_seed(rng):
        seeds.append(real(rng))
        return seeds[-1]

    tfa.draw_seed = draw_seed
    try:
        tr = _trainer("bert", mesh, "fused")
        st = tr.init_state(SEED)
        tr.train_step(st, _batches("bert")[0])
    finally:
        tfa.draw_seed = real
    return seeds


def _rank(rank, geo):
    stages, dp, mp = geo
    mesh = make_pp_mesh(stages, data_parallel=dp, model_parallel=mp,
                        devices=["cpu"] * dist.get_world_size())
    out = {"pipe_rank": mesh.pipe_rank}
    for family in FAMILIES:
        tr = _trainer(family, mesh)
        st = tr.init_state(SEED)
        init = _np(tr.model_params(st))
        train0, train1, tail = _batches(family)
        losses = [float(tr.train_step(st, b)) for b in (train0, train1)]
        params2 = _np(tr.model_params(st))
        losses.append(float(tr._train_step_masked(
            st, tr._put_batch(tail), TAIL_VALID)))
        params3 = _np(tr.model_params(st))  # a collective: every rank
        faults = _faults(family, mesh)
        r = {"losses": losses}
        if rank == 0:
            r.update(init=init, params2=params2, params3=params3,
                     faults=faults)
        out[family] = r
    if geo == (2, 1, 1):
        out["seeds"] = _kernel_seeds(mesh)
    return out


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """{geometry: future of its ranks' results, "driver": future of the
    resume runs}: the geometries start at once, the driver runs when they
    have ended (fewer processes at a time under a loaded run)."""
    pool = concurrent.futures.ThreadPoolExecutor(len(GEOMETRIES) + 1)
    runs = {geo: pool.submit(run_ranks, _rank, int(np.prod(geo)), (geo,),
                             timeout_s=RANK_TIMEOUT_S,
                             devices=["cpu"] * int(np.prod(geo)))
            for geo in GEOMETRIES}
    geometries = list(runs.values())
    tmp = tmp_path_factory.mktemp("pp_threefry")

    def driver():
        concurrent.futures.wait(geometries)
        return _driver_runs(tmp)

    runs["driver"] = pool.submit(driver)
    yield runs
    pool.shutdown(wait=True)


# ---- the JAX side -----------------------------------------------------------


def _jax_model(family):
    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MultimodalConfig as JMultimodalConfig,
        XLNetConfig as JXLNetConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert
    from bert_multimodal_transformer_tpu.models import xlnet as jxlnet

    mm = JMultimodalConfig(dropout_prob=RATE,
                           injection_index=INJ if family == "xlnet" else 0)
    if family == "xlnet":
        cfg = dataclasses.replace(JXLNetConfig.tiny(V), n_layer=L,
                                  dropout=RATE, summary_last_dropout=RATE)
        return jxlnet.MagXLNetForSequenceClassification(
            cfg, mm, visual_dim=DV, acoustic_dim=DA)
    cfg = dataclasses.replace(JBertConfig.tiny(V), num_hidden_layers=L,
                              hidden_dropout_prob=RATE,
                              attention_probs_dropout_prob=RATE)
    return jbert.MagBertForSequenceClassification(
        cfg, mm, visual_dim=DV, acoustic_dim=DA)


def _to_port(family, tree):
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
        xlnet_params_from_flax,
    )

    convert = xlnet_params_from_flax if family == "xlnet" else \
        params_from_flax
    return _np(convert(tree))


def _jax_run(family, geo, params):
    """The JAX pipeline's two train steps and masked step from ``params``
    and the state key ``fold_in(PRNGKey(SEED), 1)`` (its ``init_state``)
    on a (data, pipe, model) mesh of the virtual devices."""
    import jax

    from bert_multimodal_transformer_tpu.parallel.pp import (
        PipelineTrainer,
        make_pp_mesh as jmake_pp_mesh,
    )
    from bert_multimodal_transformer_tpu.parallel.pp_xlnet import (
        XLNetPipelineTrainer,
    )
    from bert_multimodal_transformer_tpu.training import optim as joptim

    stages, dp, mp = geo
    mesh = jmake_pp_mesh(stages, data_parallel=dp, model_parallel=mp,
                         devices=jax.devices()[:stages * dp * mp])
    cls = XLNetPipelineTrainer if family == "xlnet" else PipelineTrainer
    jtr = cls(model=_jax_model(family), mesh=mesh, n_micro=N_MICRO,
              donate=False,
              tx=joptim.make_optimizer(LR, 10, warmup_proportion=0.0))
    st = jtr.create_state_from_params(
        params, jax.random.fold_in(jax.random.PRNGKey(SEED), 1))
    train0, train1, tail = _batches(family)
    losses = []
    for b in (train0, train1):
        st, loss = jtr.train_step(st, b)
        losses.append(float(loss))
    params2 = jtr.model_params(st)
    st, loss = jtr._train_step_masked(st, jtr._put_batch(tail),
                                      jax.device_put(TAIL_VALID, jtr._bsh))
    losses.append(float(loss))
    return {"losses": losses, "params2": _to_port(family, params2),
            "params3": _to_port(family, jtr.model_params(st))}


def _jax_init_params(family):
    import jax

    return jax.device_get(jax.jit(_jax_model(family).init)(
        jax.random.PRNGKey(SEED), *_batch(0, family)[:5])["params"])


@pytest.fixture(scope="module")
def jax_init(rank_runs):
    """{family: the JAX model's params from PRNGKey(SEED)} (asks for the
    ranks first, so they run while JAX works)."""
    with concurrent.futures.ThreadPoolExecutor(len(FAMILIES)) as pool:
        return dict(zip(FAMILIES, pool.map(_jax_init_params, FAMILIES)))


@pytest.fixture(scope="module")
def jax_runs(jax_init):
    """{(family, geometry): the JAX pipeline's run at that geometry}, the
    JAX programs compiled in threads."""
    runs = [(f, g) for f in FAMILIES for g in GEOMETRIES]
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        done = {run: pool.submit(_jax_run, *run, jax_init[run[0]])
                for run in runs}
        return {run: fut.result() for run, fut in done.items()}


def _assert_close(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    for which in ("params2", "params3"):
        for k, w in want[which].items():
            np.testing.assert_allclose(got[which][k], w, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{which} {k}")


# ---- the tests --------------------------------------------------------------


@pytest.mark.parametrize("geo", GEOMETRIES, ids=["pp2", "pp2-dp2", "pp2-mp2"])
@pytest.mark.parametrize("family", FAMILIES)
def test_init_matches_jax_init(family, geo, rank_runs, jax_init, jax_runs):
    """``init_state(seed)`` on every stage draws the whole model as the
    one-device threefry ``Trainer.init_state(seed)`` does, bit for bit,
    and so as the JAX ``model.init(PRNGKey(seed))``: the same bits, the
    normal initializer's values within ``NORMAL_RTOL`` (XLA's ``log1p``
    is not torch's, ``utils/jax_random.py``). XLNet's unused
    ``mask_emb``, which the JAX tree lacks, aside. (It asks for the JAX
    runs too, so that they compile while the ranks work.)"""
    got = rank_runs[geo].result()[0][family]["init"]
    tr = ttr.Trainer(model=_model(family), rng_impl="threefry2x32",
                     tx=toptim.make_optimizer(LR, 10))
    one = _np(tr.init_state(SEED).model.state_dict())
    assert set(one) == set(got)
    for k, w in one.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    want = _to_port(family, jax_init[family])
    assert set(want) == set(got) - {"transformer.mask_emb"}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=NORMAL_RTOL, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=["pp2", "pp2-dp2", "pp2-mp2"])
@pytest.mark.parametrize("family", FAMILIES)
def test_steps_match_jax_pipeline(family, geo, rank_runs, jax_runs):
    """Two train steps, then the masked step: every rank's losses and
    rank 0's params after the train steps and after the masked one."""
    ranks = rank_runs[geo].result()
    want = jax_runs[(family, geo)]
    for r in ranks:
        np.testing.assert_allclose(r[family]["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
    _assert_close(ranks[0][family], want)


def _band_excess(got, want):
    """How far ``got``'s two train steps sit past the band, as a multiple
    of it (below 1: within)."""
    loss = max(abs(g - w) / (LOSS_RTOL * abs(w))
               for g, w in zip(got["losses"], want["losses"]))
    params = max(float(np.max(np.abs(got["params2"][k] - w)
                              / (PARAM_ATOL + PARAM_RTOL * np.abs(w))))
                 for k, w in want["params2"].items())
    return max(loss, params)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=["pp2", "pp2-dp2", "pp2-mp2"])
@pytest.mark.parametrize("family", FAMILIES)
def test_planted_faults_leave_the_band(family, geo, rank_runs, jax_runs):
    """Each planted fault's two steps land far outside the band the right
    steps hold: the layer key folded with the local index (BERT), the
    position mask as the prologue's ``Dropout_0`` (XLNet), the inner FFN
    mask drawn at full width and sliced (XLNet, PP×TP)."""
    (name, got), = rank_runs[geo].result()[0][family]["faults"].items()
    assert name == (TP_FAULT if family == "xlnet" and geo[2] > 1
                    else FAULTS[family])
    assert _band_excess(got, jax_runs[(family, geo)]) > 100, name


def test_fused_kernel_seeds_are_jaxs_randint(rank_runs):
    """The fused BERT step at (2, 1, 1): stage r's seeds, microbatch by
    microbatch, are JAX's ``randint(k, (1, 1), 0, 2**31 - 1)`` of the
    ``attention`` key its layer ``rank·k + j`` draws under
    ``fold_in(fold_in(split(state.rng)[0], m), i)``."""
    import jax
    from flax.core import scope as flax_scope

    from bert_multimodal_transformer_tpu.models import bert as jbert

    cfg = _jax_model("bert").config
    layer = jbert.BertLayer(cfg)
    x = np.zeros((B // N_MICRO, S, cfg.hidden_size), np.float32)
    params = layer.init(jax.random.PRNGKey(0), x, None)["params"]
    state_key = jax.random.fold_in(jax.random.PRNGKey(SEED), 1)
    step_key = jax.random.split(state_key)[0]
    keys, real = [], flax_scope.Scope.make_rng

    def make_rng(self, name="params"):
        key = real(self, name)
        if name == "dropout" and self.path[-1:] == ("attention",):
            keys.append(key)
        return key

    k = L // 2
    want = {0: [], 1: []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_scope.Scope, "make_rng", make_rng)
        for stage in (0, 1):
            for m in range(N_MICRO):
                for j in range(k):
                    key = jax.random.fold_in(jax.random.fold_in(step_key, m),
                                             stage * k + j)
                    keys.clear()
                    layer.apply({"params": params}, x, None,
                                deterministic=False, rngs={"dropout": key})
                    (att,) = keys
                    want[stage].append(int(jax.random.randint(
                        att, (1, 1), 0, 2 ** 31 - 1)[0, 0]))
    for r in rank_runs[(2, 1, 1)].result():
        assert r["seeds"] == want[r["pipe_rank"]]


def test_local_stream_draws_for_the_local_shape():
    """A site of a ``local`` stream (the pipeline's) drops a column shard
    with JAX's ``bernoulli(key, 1 − p, local shape)``, as ``_TPXLNetFF``
    draws under ``shard_map``; a site of another stream with the full
    width's mask, sliced to the shard (the GSPMD layer's)."""
    import jax

    x = torch.ones(3, 8)
    shard = (1, 32, 8)    # the second of four 8-column chunks of 32
    jkey = jax.random.fold_in(jax.random.PRNGKey(SEED), 5)
    want = {True: jax.random.bernoulli(jkey, 1 - RATE, (3, 8)),
            False: jax.random.bernoulli(jkey, 1 - RATE, (3, 32))[:, 8:16]}
    assert not np.array_equal(want[True], want[False])
    for local in (True, False):
        rngs = ThreefryRngs.from_key(jax_random.PRNGKey(SEED), local=local)
        site = rngs.child("layer").mask()
        assert site.local == local
        site = SiteKey(jax_random.fold_in(jax_random.PRNGKey(SEED), 5),
                       local=site.local)
        got = dropout(x, RATE, site, shard=shard) != 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[local]),
                                      err_msg=f"local={local}")


# ---- the driver -------------------------------------------------------------


def _argv(ckpt_dir, *extra, rng_impl="threefry2x32"):
    return ["--dataset", "mosi", "--synthetic", "--tiny", "--device", "cpu",
            "--train_batch_size", "8", "--dev_batch_size", "8",
            "--test_batch_size", "8", "--synthetic_sizes", "20", "8", "8",
            "--seed", "5", "--compute_dtype", "float32",
            "--pipeline_parallel", "2", "--pp_microbatches", "2",
            "--rng_impl", rng_impl, "--checkpoint_dir", str(ckpt_dir),
            "--n_epochs", "2", *extra]


def _driver_runs(tmp):
    """The uninterrupted run and one interrupted after 2 steps (saved
    every step) start together; then the interrupted one resumes, and a
    copy of it resumes under ``--rng_impl rbg``. Returns the exit codes."""
    def run(name, *extra, **kw):
        return tdriver.run(_argv(tmp / name, *extra, **kw),
                           rank_timeout_s=RANK_TIMEOUT_S)[0]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        straight = pool.submit(run, "straight")
        rcs = {"first": run("resumed", "--save_every_steps", "1",
                            "--max_steps", "2")}
        shutil.copytree(tmp / "resumed", tmp / "other")
        other = pool.submit(run, "other", "--resume", rng_impl="rbg")
        rcs["resumed"] = run("resumed", "--resume")
        rcs["straight"], rcs["other"] = straight.result(), other.result()
    return tmp, rcs


def test_driver_midepoch_resume_bit_exact(rank_runs):
    """Interrupted after 2 steps (saved every step), resumed, the run ends
    at the uninterrupted one's params, moments, count, key and step; the
    same checkpoint resumed under ``--rng_impl rbg`` exits 2."""
    tmp, rcs = rank_runs["driver"].result()
    assert rcs == {"first": 0, "resumed": 0, "straight": 0, "other": 2}
    a, b = (CheckpointManager(str(tmp / n)) for n in ("straight", "resumed"))
    assert a.latest_step() == b.latest_step()
    pa, pb = a.restore_params(), b.restore_params()
    assert pp.is_pp_layout(pa) and set(pa) == set(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    ta, tb = (torch.load(f"{m.directory}/{m.latest_step()}/"
                         f"{TRAIN_STATE_FILE}", weights_only=True)
              for m in (a, b))
    assert ta["rng_impl"] == tb["rng_impl"] == "threefry2x32"
    assert ta["step"] == tb["step"] and torch.equal(ta["rng"], tb["rng"])
    assert ta["opt_state"]["count"] == tb["opt_state"]["count"]
    for key in ("exp_avg", "exp_avg_sq"):
        for k, v in ta["opt_state"][key].items():
            assert torch.equal(v, tb["opt_state"][key][k]), (key, k)


@pytest.fixture(autouse=True, scope="module")
def _jax_threefry():
    """JAX's default stream, threefry2x32, for this module (as
    ``tests/test_torch_threefry_parallel.py``)."""
    import jax

    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", before)


@pytest.fixture(autouse=True, scope="module")
def _no_wandb():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WANDB_MODE", "disabled")
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_resume.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
