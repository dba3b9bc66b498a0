"""Rematerialized encoder layers (``models/remat.py``, ``--remat``) on the
CPU: the port's remat forward against the JAX package's ``remat=True``
models with the same weights (BERT under both policies, XLNet) within
``FP32_ATOL`` of ``tests/test_torch_bert.py``; with dropout on, the loss,
every gradient and the dropout generator after two steps with and without
remat equal bit for bit on the einsum and the fused branch (the kernels'
plain versions here), both families and both BERT policies, which holds
only if the recompute replays the layer's dropout draws; the refusals; and
the driver's ``--remat`` runs against the runs without it, on one device
and over two tensor-parallel ranks.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu.config import (
    BertConfig as JBertConfig,
    MultimodalConfig as JMultimodalConfig,
    XLNetConfig as JXLNetConfig,
)
from bert_multimodal_transformer_tpu.models import bert as jbert
from bert_multimodal_transformer_tpu.models import xlnet as jxl
from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.models import bert as tbert
from bert_multimodal_transformer_tpu_torch.models import xlnet as txl
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
    xlnet_params_from_flax,
)

B, S, DV, DA = 3, 12, 5, 7
FP32_ATOL = 1e-4
RANK_TIMEOUT_S = 240


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 128, (B, S)).astype(np.int32)
    vis = rng.randn(B, S, DV).astype(np.float32)
    ac = rng.randn(B, S, DA).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, 8:] = 0
    segs = np.zeros((B, S), np.int32)
    segs[2, 6:] = 1
    labels = rng.randn(B, 1).astype(np.float32)
    return ids, vis, ac, mask, segs, labels


def _port_model(family, attention_impl="einsum", remat=False, policy="full",
                dropout=0.1):
    mm = MultimodalConfig(beta_shift=1.0, dropout_prob=dropout,
                          injection_index=1 if family == "xlnet" else 0,
                          use_fused_kernel=attention_impl == "fused")
    if family == "bert":
        cfg = dataclasses.replace(
            BertConfig.tiny(), attention_impl=attention_impl,
            hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
        return tbert.MagBertForSequenceClassification(
            cfg, mm, DV, DA, torch.float32, remat, policy, device="cpu")
    cfg = dataclasses.replace(XLNetConfig.tiny(),
                              attention_impl=attention_impl, dropout=dropout,
                              summary_last_dropout=dropout)
    return txl.MagXLNetForSequenceClassification(
        cfg, mm, DV, DA, torch.float32, remat, device="cpu")


@pytest.mark.parametrize("family,policy", [("bert", "full"),
                                           ("bert", "dots"),
                                           ("xlnet", "full")])
def test_remat_forward_matches_jax(family, policy):
    """The JAX ``remat=True`` model and the port's, same weights; the port
    runs with a gradient taken, so its layers go through the checkpoint,
    and its backward reaches every param."""
    ids, vis, ac, mask, segs, _ = _inputs()
    if family == "bert":
        jmodel = jbert.MagBertForSequenceClassification(
            JBertConfig.tiny(), JMultimodalConfig(), visual_dim=DV,
            acoustic_dim=DA, remat=True, remat_policy=policy)
        convert = params_from_flax
    else:
        jmodel = jxl.MagXLNetForSequenceClassification(
            JXLNetConfig.tiny(), JMultimodalConfig(injection_index=1),
            visual_dim=DV, acoustic_dim=DA, remat=True)
        convert = xlnet_params_from_flax
    params = jmodel.init(jax.random.PRNGKey(0), ids, vis, ac,
                         attention_mask=mask, token_type_ids=segs)["params"]
    want = jmodel.apply({"params": params}, jnp.asarray(ids), vis, ac,
                        attention_mask=mask, token_type_ids=segs,
                        deterministic=True)
    tmodel = _port_model(family, remat=True, policy=policy)
    # a JAX XLNet init without target_mapping makes no mask_emb
    missing, unexpected = tmodel.load_state_dict(
        convert(jax.device_get(params)), strict=False)
    assert not unexpected and set(missing) <= {"transformer.mask_emb"}
    got = tmodel(*(torch.from_numpy(a) for a in (ids, vis, ac)),
                 attention_mask=torch.from_numpy(mask),
                 token_type_ids=torch.from_numpy(segs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FP32_ATOL, rtol=0)
    got.sum().backward()
    for name, p in tmodel.named_parameters():
        if "mask_emb" not in name:   # the query stream's, unused here
            assert p.grad is not None, name


def _two_steps(model):
    """Two training forwards and backwards at dropout 0.1 from one CPU
    generator: (losses, every gradient of the second, the generator's
    state after)."""
    ids, vis, ac, mask, segs, labels = (torch.from_numpy(a)
                                        for a in _inputs(seed=1))
    gen = torch.Generator().manual_seed(5)
    losses = []
    for _ in range(2):
        model.zero_grad()
        loss = model(ids, vis, ac, mask, segs, labels=labels,
                     deterministic=False, dropout_rng=gen)[0]
        loss.backward()
        losses.append(loss.item())
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return losses, grads, gen.get_state()


@pytest.mark.parametrize("family,impl,policy", [
    ("bert", "einsum", "full"), ("bert", "einsum", "dots"),
    ("bert", "fused", "full"), ("bert", "fused", "dots"),
    ("xlnet", "einsum", "full"), ("xlnet", "fused", "full")])
def test_remat_gradients_equal_plain_bit_for_bit(family, impl, policy):
    """With dropout on (hidden, MAG, attention probs: the fused branch's
    seeds from the host generator, the rest from the device generator),
    a rematerialized step draws what the plain step draws: same losses,
    same gradients, same generator state."""
    want = _two_steps(_port_model(family, impl))
    got = _two_steps(_port_model(family, impl, remat=True, policy=policy))
    assert got[0] == want[0]
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("family", ["bert", "xlnet"])
def test_remat_refuses_output_attentions(family):
    model = _port_model(family, remat=True)
    ids, vis, ac, mask, segs, _ = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="output_attentions is "
                                         "incompatible with remat"):
        model(ids, vis, ac, mask, segs, output_attentions=True)


def test_bad_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy must be 'full' or "
                                         "'dots', got 'offload'"):
        _port_model("bert", remat=True, policy="offload")
    # as in JAX, the policy is read only under remat
    _port_model("bert", remat=False, policy="offload")


DRIVER_ARGV = ["--synthetic", "--tiny", "--device", "cpu", "--n_epochs", "2",
               "--train_batch_size", "8", "--synthetic_sizes", "16", "8",
               "8", "--seed", "4", "--attention_impl", "fused",
               "--use_fused_mag"]


def test_driver_remat_dots_matches_the_plain_run(capsys):
    """``--remat --remat_policy dots`` prints the loss history of the run
    without it, digit for digit (fused attention and MAG gate, bf16)."""
    lines = []
    for extra in ([], ["--remat", "--remat_policy", "dots"]):
        assert tdriver.main(DRIVER_ARGV + extra) == 0
        lines.append([x for x in capsys.readouterr().out.splitlines()
                      if x.startswith("epoch:")])
    assert len(lines[0]) == 2
    assert lines[1] == lines[0]


def test_driver_remat_under_model_parallel():
    """Two tensor-parallel ranks (head-sharded attention) with ``--remat``
    against the same ranks without: every rank's epoch records equal but
    for their times; a layer's collectives recompute in the same order on
    both ranks."""
    argv = DRIVER_ARGV[:-1] + ["--model_parallel", "2",
                               "--tp_shard_attention"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(tdriver.run, argv + extra,
                            rank_timeout_s=RANK_TIMEOUT_S)
                for extra in ([], ["--remat"])]
        (rc0, plain), (rc1, remat) = (r.result() for r in runs)
    assert rc0 == rc1 == 0

    def records(ranks):
        return [[{k: v for k, v in rec.items() if k != "epoch_seconds"}
                 for rec in r["history"]] for r in ranks]

    assert len(plain) == 2 and len(plain[0]["history"]) == 2
    assert records(remat) == records(plain)


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
