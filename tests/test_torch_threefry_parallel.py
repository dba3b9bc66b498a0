"""Parallel training under ``rng_impl="threefry2x32"``, on CPU ranks over
gloo (spawned under a timeout of their own, in the background while the
JAX steps compile), with dropout on (rate 0.1, einsum attention).

* Two data ranks, plain and FSDP: each draws its rows of the global
  batch's masks, so two steps equal one card's from the same weights and
  key within the
  parallel band (losses rtol 1e-6, params rtol 1e-5 / atol 1e-7, the band
  of ``tests/test_torch_shard_map.py``: only the gradient sum's order
  differs), and the JAX ``Trainer``'s GSPMD step on a two-device data
  mesh, which draws the same global masks;
* the explicit-collectives step folds the data index into the step's key
  (``fold_in(rng, data_index)``) and draws its local rows' masks, as the
  JAX ``make_shard_map_train_step``: equal to it on a two-device mesh
  within the same band;
* two tensor-parallel ranks (heads and FFN columns sharded): each draws
  its slice of one card's masks, so two steps equal one card's.
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
)
from bert_multimodal_transformer_tpu_torch.models.bert import (
    MagBertForSequenceClassification,
)
from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
    make_mesh,
    run_ranks,
)
from bert_multimodal_transformer_tpu_torch.parallel.shard_map_step import (
    make_shard_map_train_step,
)
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttr
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
)

DV, DA, S, B, V = 3, 4, 12, 16, 64
LR, RATE = 1e-3, 0.1
RANK_TIMEOUT_S = 240
LOSS_RTOL = 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7


def make_batch(seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), np.int32)
    mask[::3, 9:] = 0
    return (rng.randint(0, V, (B, S)).astype(np.int32) * mask,
            rng.randn(B, S, DV).astype(np.float32),
            rng.randn(B, S, DA).astype(np.float32),
            mask, np.zeros((B, S), np.int32),
            rng.uniform(-3, 3, (B,)).astype(np.float32))


BATCHES = [make_batch(0), make_batch(1)]


def _model():
    cfg = dataclasses.replace(BertConfig.tiny(V), hidden_dropout_prob=RATE,
                              attention_probs_dropout_prob=RATE)
    return MagBertForSequenceClassification(
        cfg, MultimodalConfig(beta_shift=1.0, dropout_prob=RATE), DV, DA,
        device="cpu")


def _steps(params, mesh=None, explicit=False, shard_attention=False,
           fsdp=False):
    """Two threefry train steps from ``params`` and state key PRNGKey(1):
    (losses, the full params after them)."""
    from bert_multimodal_transformer_tpu_torch.parallel import tp

    tr = ttr.Trainer(model=_model(), mesh=mesh, rng_impl="threefry2x32",
                     tp_shard_attention=shard_attention, fsdp=fsdp,
                     tx=toptim.make_optimizer(LR, 10, warmup_proportion=0.0))
    st = tr.create_state_from_params(params, 1)
    step = make_shard_map_train_step(mesh) if explicit else tr._train_step
    losses = [float(step(st, tr._put_batch(b))) for b in BATCHES]
    full = tp.full_state_dict(st.model) if mesh is not None else \
        st.model.state_dict()
    return losses, {k: v.detach().numpy().copy() for k, v in full.items()}


def _rank(rank, params_np):
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    world = ["cpu"] * dist.get_world_size()
    dp = make_mesh(MeshConfig(data_parallel=-1), world)
    out = {"data": _steps(params, dp),
           "explicit": _steps(params, dp, explicit=True),
           "fsdp": _steps(params, dp, fsdp=True)}
    tpm = make_mesh(MeshConfig(data_parallel=-1, model_parallel=2), world)
    out["tp"] = _steps(params, tpm, shard_attention=True)
    return out


@pytest.fixture(scope="module")
def jax_side():
    import jax

    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MultimodalConfig as JMultimodalConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert

    cfg = dataclasses.replace(JBertConfig.tiny(vocab_size=V),
                              hidden_dropout_prob=RATE,
                              attention_probs_dropout_prob=RATE)
    jmodel = jbert.MagBertForSequenceClassification(
        cfg, JMultimodalConfig(beta_shift=1.0, dropout_prob=RATE),
        visual_dim=DV, acoustic_dim=DA)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  *BATCHES[0][:5])["params"]
    return jmodel, jax.device_get(params)


@pytest.fixture(scope="module")
def full_params(jax_side):
    return {k: v.numpy() for k, v in params_from_flax(jax_side[1]).items()}


@pytest.fixture(scope="module")
def ranks(full_params):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _rank, 2, (full_params,),
                          timeout_s=RANK_TIMEOUT_S, devices=["cpu"] * 2)


@pytest.fixture(scope="module")
def one_card(full_params, ranks):
    """One card's steps (asks for the ranks first, so they run beside)."""
    return _steps({k: torch.from_numpy(v) for k, v in full_params.items()})


def _jax_steps(jax_side, explicit):
    """The JAX step on a two-device data mesh: the Trainer's GSPMD step,
    or the explicit shard_map step; (losses, port-named params)."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        MeshConfig as JMeshConfig,
    )
    from bert_multimodal_transformer_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )
    from bert_multimodal_transformer_tpu.parallel.shard_map_step import (
        make_shard_map_train_step as jmake_step,
    )
    from bert_multimodal_transformer_tpu.training import optim as joptim
    from bert_multimodal_transformer_tpu.training import trainer as jtrainer

    jmodel, params = jax_side
    mesh = jmake_mesh(JMeshConfig(data_parallel=-1),
                      devices=jax.devices()[:2])
    jtr = jtrainer.Trainer(model=jmodel, mesh=mesh, donate=False,
                           tx=joptim.make_optimizer(LR, 10, 0.0))
    st = jtr.create_state_from_params(params, jax.random.PRNGKey(1))
    step = jmake_step(mesh) if explicit else jtr._train_step
    losses = []
    for b in BATCHES:
        st, loss = step(st, jtr._put_batch(b))
        losses.append(float(loss))
    return losses, {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(st.params)).items()}


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for k, w in want[1].items():
        np.testing.assert_allclose(got[1][k], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def test_two_data_ranks_equal_one_card_and_the_jax_gspmd_step(
        ranks, one_card, jax_side):
    """Plain data parallelism and FSDP (which gathers the same model)."""
    out = ranks.result()
    for r in out:
        _assert_close(r["data"], one_card)
        _assert_close(r["fsdp"], one_card)
    _assert_close(out[0]["data"], _jax_steps(jax_side, explicit=False))


def test_explicit_step_folds_the_data_index_as_jax(ranks, one_card,
                                                  jax_side):
    out = ranks.result()
    want = _jax_steps(jax_side, explicit=True)
    _assert_close(out[0]["explicit"], want)
    assert out[1]["explicit"][0] == out[0]["explicit"][0]
    # its masks are not the global batch's: another loss than one card's
    assert abs(out[0]["explicit"][0][0] - one_card[0][0]) > 1e-6


def test_two_tensor_parallel_ranks_equal_one_card(ranks, one_card):
    for r in ranks.result():
        _assert_close(r["tp"], one_card)


@pytest.fixture(autouse=True, scope="module")
def _jax_threefry():
    """JAX's default stream, threefry2x32, for this module: the JAX
    driver's tests run in process set ``jax_default_prng_impl`` from its
    ``--rng_impl`` flag (default rbg) and a worker runs modules one after
    another."""
    import jax

    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", before)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_resume.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
