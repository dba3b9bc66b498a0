"""The explicit-collectives step (``parallel/shard_map_step.py``) against the
port's data-parallel ``Trainer`` step and the JAX package's
``make_shard_map_train_step`` (the contract of ``tests/test_shard_map.py``).

* On two CPU data ranks over gloo (spawned under a timeout of their own,
  in the background while the JAX step compiles): from the same weights,
  rows and seed, the step equals the ``Trainer``'s data-parallel step bit
  for bit (it is that step under the JAX name), the losses and every
  parameter after two steps, on the fused
  branch (the kernels' plain versions) at dropout 0.1 and on einsum at
  dropout 0;
* at dropout 0 it matches the JAX ``make_shard_map_train_step`` on a
  two-device data mesh from the same weights within the band of
  ``tests/test_shard_map.py`` (losses rtol 1e-6, params rtol 1e-5 atol
  1e-7), the JAX step with the same AdamW;
* a mesh with a model axis is refused.
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
    Mesh,
    make_mesh,
    run_ranks,
)
from bert_multimodal_transformer_tpu_torch.parallel.shard_map_step import (
    make_shard_map_train_step,
)
from bert_multimodal_transformer_tpu_torch.training import optim as toptim
from bert_multimodal_transformer_tpu_torch.training import trainer as ttr

DV, DA, S, B, V = 3, 4, 12, 16, 64
LR, N_STEPS = 1e-3, 2
RANK_TIMEOUT_S = 240
LOSS_RTOL = 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7


def make_batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (B, S)).astype(np.int32),
            rng.randn(B, S, DV).astype(np.float32),
            rng.randn(B, S, DA).astype(np.float32),
            np.ones((B, S), np.int32), np.zeros((B, S), np.int32),
            rng.uniform(-3, 3, (B,)).astype(np.float32))


BATCHES = [make_batch(0), make_batch(1)]


def _model(impl, rate):
    cfg = dataclasses.replace(BertConfig.tiny(V), attention_impl=impl,
                              hidden_dropout_prob=rate,
                              attention_probs_dropout_prob=rate)
    return MagBertForSequenceClassification(
        cfg, MultimodalConfig(beta_shift=1.0, dropout_prob=rate), DV, DA,
        device="cpu")


def _steps(mesh, impl, rate, params, explicit):
    """N_STEPS steps of the Trainer's data-parallel step, or of the
    explicit-collectives step: (losses, the params after them)."""
    tr = ttr.Trainer(model=_model(impl, rate), mesh=mesh,
                     tx=toptim.make_optimizer(LR, 10, warmup_proportion=0.0))
    st = tr.create_state_from_params(params, 7)
    step = make_shard_map_train_step(mesh) if explicit else tr._train_step
    losses = [float(step(st, tr._put_batch(b))) for b in BATCHES]
    return losses, {k: v.detach().numpy().copy()
                    for k, v in st.model.state_dict().items()}


def _rank(rank, params_np):
    mesh = make_mesh(MeshConfig(data_parallel=-1),
                     ["cpu"] * dist.get_world_size())
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    return {(impl, rate, explicit): _steps(mesh, impl, rate, params,
                                           explicit)
            for impl, rate in (("fused", 0.1), ("einsum", 0.0))
            for explicit in (False, True)}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model's init (the weights both sides start from)."""
    import jax

    from bert_multimodal_transformer_tpu.config import (
        BertConfig as JBertConfig,
        MultimodalConfig as JMultimodalConfig,
    )
    from bert_multimodal_transformer_tpu.models import bert as jbert

    cfg = dataclasses.replace(JBertConfig.tiny(vocab_size=V),
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    jmodel = jbert.MagBertForSequenceClassification(
        cfg, JMultimodalConfig(beta_shift=1.0, dropout_prob=0.0),
        visual_dim=DV, acoustic_dim=DA)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  *BATCHES[0][:5])["params"]
    return jmodel, jax.device_get(params)


@pytest.fixture(scope="module")
def ranks(jax_side):
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    params = {k: v.numpy() for k, v in params_from_flax(jax_side[1]).items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _rank, 2, (params,),
                          timeout_s=RANK_TIMEOUT_S, devices=["cpu"] * 2)


@pytest.fixture(scope="module")
def jax_steps(jax_side, ranks):
    """The JAX explicit step on a two-device data mesh: (losses, port-named
    params); asks for the ranks first, so they run while JAX compiles."""
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
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        params_from_flax,
    )

    jmodel, params = jax_side
    mesh = jmake_mesh(JMeshConfig(data_parallel=-1),
                      devices=jax.devices()[:2])
    jtr = jtrainer.Trainer(model=jmodel, mesh=mesh, donate=False,
                           tx=joptim.make_optimizer(LR, 10, 0.0))
    st = jtr.create_state_from_params(params, jax.random.PRNGKey(1))
    step = jmake_step(mesh)
    losses = []
    for b in BATCHES:
        st, loss = step(st, jtr._put_batch(b))
        losses.append(float(loss))
    return losses, {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(st.params)).items()}


@pytest.mark.parametrize("impl,rate", [("fused", 0.1), ("einsum", 0.0)])
def test_explicit_step_is_the_trainers_step_bit_for_bit(ranks, impl, rate):
    """Every rank: the same losses and params, bit for bit, as the
    Trainer's data-parallel step; the ranks agree; the steps moved the
    params (and with dropout, the masks differed from dropout 0's)."""
    out = ranks.result()
    for r in out:
        (lt, pt), (le, pe) = r[impl, rate, False], r[impl, rate, True]
        assert lt == le
        assert all(np.array_equal(pt[k], pe[k]) for k in pt)
    assert out[0][impl, rate, True][0] == out[1][impl, rate, True][0]
    losses = {k: v[0] for k, v in out[0].items()}
    assert losses["fused", 0.1, True] != losses["einsum", 0.0, True]
    assert all(np.isfinite(losses[impl, rate, True]))


def test_explicit_step_matches_the_jax_shard_map_step(ranks, jax_steps):
    """At dropout 0 against the JAX ``make_shard_map_train_step`` on a
    two-device data mesh, the band of ``tests/test_shard_map.py``."""
    want_losses, want = jax_steps
    losses, got = ranks.result()[0]["einsum", 0.0, True]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def test_explicit_step_refuses_a_model_axis():
    mesh = Mesh(data_size=1, model_size=2, rank=0,
                device=torch.device("cpu"), backend=None)
    with pytest.raises(ValueError, match="data-parallel"):
        make_shard_map_train_step(mesh)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tiny shapes (as
    ``tests/test_torch_fsdp.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
