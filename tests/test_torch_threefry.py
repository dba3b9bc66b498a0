"""The port's replay of JAX's threefry2x32 stream and Flax's key derivation
(``utils/jax_random.py``, ``utils/flax_rng.py``) and the threefry dropout
(``ops/dropout.py``: kernel T's plain version), against ``jax.random`` and
Flax on the CPU.

* ``PRNGKey``, ``split``, ``fold_in``, ``random_bits``, ``uniform``,
  ``bernoulli`` and ``randint`` equal ``jax.random`` bit for bit; ``normal``
  (XLA's float32 ``erf_inv`` replayed with torch's ``log1p``) is within
  2e-6 relative of JAX's, and equal on most elements;
* the threefry dropout equals Flax's ``nn.Dropout`` at the same key, bit
  for bit, in bf16 and fp32, and a column shard, a row slice and both at
  once equal the full draw's slice (the kernel's layout, ``threefry_layout``,
  checked through its plain version);
* every dropout and param site of tiny MAG-BERT and MAG-XLNet (two-stream
  attention included) draws the key the JAX model's ``make_rng`` gives
  there, read by intercepting Flax's ``Scope.make_rng``;
* ``init_params_threefry`` equals JAX's ``model.init(PRNGKey(s))``,
  converted: the uniform and constant params bit for bit, the normal ones
  within 2e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.core import scope as flax_scope

from bert_multimodal_transformer_tpu.config import (
    BertConfig as JBertConfig,
    MultimodalConfig as JMultimodalConfig,
    XLNetConfig as JXLNetConfig,
)
from bert_multimodal_transformer_tpu.models import bert as jbert
from bert_multimodal_transformer_tpu.models import xlnet as jxlnet
from bert_multimodal_transformer_tpu_torch.config import (
    BertConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.models import bert as tbert
from bert_multimodal_transformer_tpu_torch.models import xlnet as txlnet
from bert_multimodal_transformer_tpu_torch.ops import dropout as tdrop
from bert_multimodal_transformer_tpu_torch.utils import flax_rng
from bert_multimodal_transformer_tpu_torch.utils import jax_random as jr
from bert_multimodal_transformer_tpu_torch.utils.convert import (
    params_from_flax,
    xlnet_params_from_flax,
)

NORMAL_RTOL = 2e-6
B, S, V, DV, DA = 4, 10, 64, 5, 7
RATE = 0.1


def _words(key):
    return tuple(int(x) for x in np.asarray(key))


@pytest.mark.parametrize("seed", [0, 1, 9999])
def test_prng_key(seed):
    assert jr.PRNGKey(seed) == _words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("n", [2, 3, 7])
def test_split(n):
    want = [_words(k) for k in jax.random.split(jax.random.PRNGKey(42), n)]
    assert list(jr.split(jr.PRNGKey(42), n)) == want


@pytest.mark.parametrize("data", [0, 1, 12345, 2 ** 32 - 1])
def test_fold_in(data):
    want = _words(jax.random.fold_in(jax.random.PRNGKey(7), data))
    assert jr.fold_in(jr.PRNGKey(7), data) == want


SHAPES = [(), (3, 5, 7), (300, 301)]  # 0-d, odd, > 2^16 elements


@pytest.mark.parametrize("shape", SHAPES, ids=["0d", "odd", "large"])
def test_random_bits_uniform_and_bernoulli(shape):
    k, tk = jax.random.PRNGKey(11), jr.PRNGKey(11)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(jr.random_bits(tk, shape).numpy(), want)
    np.testing.assert_array_equal(jr.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(k, shape)))
    np.testing.assert_array_equal(
        jr.uniform(tk, shape, -0.3, 0.3).numpy(),
        np.asarray(jax.random.uniform(k, shape, minval=-0.3, maxval=0.3)))
    for p in (0.9, 0.5, 0.1):
        np.testing.assert_array_equal(
            jr.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(k, p, shape)))


@pytest.mark.parametrize("lo,hi,shape", [(0, 2 ** 31 - 1, (1, 1)),
                                         (-7, 100, (50,)),
                                         (3, 3, (4,))])
def test_randint(lo, hi, shape):
    k = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.randint(k, shape, lo, hi))
    np.testing.assert_array_equal(
        jr.randint(jr.PRNGKey(5), shape, lo, hi).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES[1:], ids=["odd", "large"])
def test_normal_within_2e6_relative(shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), shape))
    got = jr.normal(jr.PRNGKey(3), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)
    assert np.mean(got == want) > 0.99


def _flax_dropout(x, key, rate=RATE):
    return np.asarray(fnn.Dropout(rate).apply(
        {}, jnp.asarray(x), deterministic=False, rngs={"dropout": key}))


def _torch(x, dtype):
    t = torch.from_numpy(np.array(x, np.float32))
    return t.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_equals_flax_bit_for_bit(dtype):
    """The full tensor, a column shard, a row slice, and rows × columns."""
    x = np.random.default_rng(0).standard_normal((6, 9, 32)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    key = jax.random.PRNGKey(21)
    want = _flax_dropout(jnp.asarray(x, jdt), key).astype(np.float32)
    xt = _torch(jnp.asarray(x, jdt).astype(jnp.float32), tdt)
    site = tdrop.ThreefryRngs.from_key(_words(key)).mask()
    got = tdrop.dropout(xt, RATE, site).float().numpy()
    np.testing.assert_array_equal(got, want)
    cols = tdrop.dropout(xt[..., 8:24].contiguous(), RATE, site,
                         shard=(-1, 32, 8)).float().numpy()
    np.testing.assert_array_equal(cols, want[..., 8:24])
    rows_site = dataclasses.replace(site, rows=(6, 2))
    rows = tdrop.dropout(xt[2:5].contiguous(), RATE,
                         rows_site).float().numpy()
    np.testing.assert_array_equal(rows, want[2:5])
    both = tdrop.dropout(xt[2:5, :, 16:].contiguous(), RATE, rows_site,
                         shard=(2, 32, 16)).float().numpy()
    np.testing.assert_array_equal(both, want[2:5, :, 16:])


def test_dropout_of_head_sharded_probs_equals_flax():
    """[B, H, S, S] probs: a data rank's rows of a TP rank's heads (the
    layout keeps two sliced dims and merges the rest)."""
    p = np.random.default_rng(1).random((4, 6, 5, 5)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = _flax_dropout(p, key)
    site = dataclasses.replace(
        tdrop.ThreefryRngs.from_key(_words(key)).mask(), rows=(4, 2))
    got = tdrop.dropout(torch.from_numpy(p[2:4, 3:6].copy()), RATE, site,
                        shard=(1, 6, 3))
    np.testing.assert_array_equal(got.numpy(), want[2:4, 3:6])
    assert tdrop.threefry_layout((2, 3, 5, 5), {0: (4, 2), 1: (6, 3)}) == (
        150, 1, 2, 3 * 25, 2 * 150 + 3 * 25, (0, 0, 150, 1))


def test_dropout_gradient_applies_the_same_mask():
    x = torch.randn(3, 4, 8, dtype=torch.float32, requires_grad=True)
    site = tdrop.ThreefryRngs.from_key((0, 9)).mask()
    y = tdrop.dropout(x, RATE, site)
    g = torch.randn_like(y)
    y.backward(g)
    keep = y.detach() != 0
    np.testing.assert_array_equal(x.grad.numpy(),
                                  torch.where(keep, g / 0.9, 0.0).numpy())


def test_kernel_seed_is_jaxs_randint_of_the_site_key():
    key = jax.random.PRNGKey(4)
    want = int(jax.random.randint(key, (1, 1), 0, 2 ** 31 - 1)[0, 0])
    assert tdrop.draw_seed(tdrop.SiteKey(_words(key))) == want


# ---- the models' sites --------------------------------------------------


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, V, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 7:] = 0
    segs = np.zeros((B, S), np.int32)
    segs[:, 6:] = 1
    vis = rng.randn(B, S, DV).astype(np.float32)
    ac = rng.randn(B, S, DA).astype(np.float32)
    return ids, vis, ac, mask, segs


def _models(family):
    if family == "bert":
        jc = dataclasses.replace(JBertConfig.tiny(V), hidden_dropout_prob=RATE,
                                 attention_probs_dropout_prob=RATE)
        tc = dataclasses.replace(BertConfig.tiny(V), hidden_dropout_prob=RATE,
                                 attention_probs_dropout_prob=RATE)
        return (jbert.MagBertForSequenceClassification(
                    jc, JMultimodalConfig(dropout_prob=RATE), DV, DA),
                tbert.MagBertForSequenceClassification(
                    tc, MultimodalConfig(dropout_prob=RATE), DV, DA,
                    device="cpu"), params_from_flax)
    jc = dataclasses.replace(JXLNetConfig.tiny(V), dropout=RATE)
    tc = dataclasses.replace(XLNetConfig.tiny(V), dropout=RATE)
    return (jxlnet.MagXLNetForSequenceClassification(
                jc, JMultimodalConfig(dropout_prob=RATE, injection_index=1),
                DV, DA),
            txlnet.MagXLNetForSequenceClassification(
                tc, MultimodalConfig(dropout_prob=RATE, injection_index=1),
                DV, DA, device="cpu"), xlnet_params_from_flax)


@pytest.fixture
def jax_draws(monkeypatch):
    """Every ``make_rng`` of the JAX model: (collection, path, counter,
    key words)."""
    seen = []
    real = flax_scope.Scope.make_rng

    def make_rng(self, name="params"):
        key = real(self, name)
        seen.append((name, tuple(self.path), self.rng_counters[name],
                     _words(key)))
        return key

    monkeypatch.setattr(flax_scope.Scope, "make_rng", make_rng)
    return seen


@pytest.fixture
def port_draws(monkeypatch):
    """Every key the port's threefry streams draw: (path, counter, key)."""
    seen = []
    real_next = flax_rng.KeyScope.next
    real_scope_key = flax_rng.scope_key

    def next_(self, name=None):
        key = real_next(self, name)
        path = self.path if name is None else self.path + (name,)
        seen.append(("dropout", path, self.counters[path], key))
        return key

    def scope_key(key, path, counter):
        # every derivation; the dropout ones are also logged by next_
        out = real_scope_key(key, path, counter)
        seen.append(("any", tuple(path), counter, out))
        return out

    monkeypatch.setattr(flax_rng.KeyScope, "next", next_)
    monkeypatch.setattr(flax_rng, "scope_key", scope_key)
    return seen


def _two_stream(rng_seed=3):
    """XLNet's two-stream inputs: a perm mask hiding the last two
    positions and a target mapping onto them."""
    perm = np.zeros((B, S, S), np.float32)
    perm[:, :, -2:] = 1.0
    tm = np.zeros((B, 2, S), np.float32)
    tm[:, 0, -2] = tm[:, 1, -1] = 1.0
    return perm, tm


@pytest.mark.parametrize("family,streams", [("bert", 1), ("xlnet", 1),
                                            ("xlnet", 2)],
                         ids=["bert", "xlnet", "xlnet-two-stream"])
def test_every_site_draws_the_jax_models_key(family, streams, jax_draws,
                                             port_draws):
    jm, tm, convert = _models(family)
    ids, vis, ac, mask, segs = _inputs()
    kw, tkw = {}, {}
    if streams == 2:
        perm, tmap = _two_stream()
        kw = dict(perm_mask=perm, target_mapping=tmap)
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    params = jm.init(jax.random.PRNGKey(3), ids, vis, ac, mask, segs,
                     **kw)["params"]
    jm.apply({"params": params}, ids, vis, ac, attention_mask=mask,
             token_type_ids=segs, deterministic=False,
             rngs={"dropout": jax.random.PRNGKey(5)}, **kw)
    tm.init_params_threefry(jr.PRNGKey(3))
    tm(*(torch.from_numpy(a) for a in (ids, vis, ac)),
       attention_mask=torch.from_numpy(mask),
       token_type_ids=torch.from_numpy(segs), deterministic=False,
       dropout_rng=tdrop.ThreefryRngs.from_key(jr.PRNGKey(5)), **tkw)
    want_drop = [d for d in jax_draws if d[0] == "dropout"]
    got_drop = [d for d in port_draws if d[0] == "dropout"]
    assert len(want_drop) > 0
    assert sorted(got_drop) == sorted(want_drop)
    want_params = {d for d in jax_draws if d[0] == "params"}
    got_params = ({("params",) + d[1:] for d in port_draws if d[0] == "any"}
                  - {("params",) + d[1:] for d in got_drop})
    if streams == 1 and family == "xlnet":
        # the port always holds mask_emb, which JAX declares only with a
        # target mapping: its key is the one JAX draws in that case
        got_params.discard(("params", ("transformer",), 1,
                            flax_rng.scope_key((0, 3), ("transformer",), 1)))
    assert got_params == want_params


@pytest.mark.parametrize("family", ["bert", "xlnet"])
def test_init_params_threefry_equals_jax_model_init(family):
    jm, tm, convert = _models(family)
    ids, vis, ac, mask, segs = _inputs()
    perm, tmap = _two_stream()
    kw = dict(perm_mask=perm, target_mapping=tmap) if family == "xlnet" \
        else {}
    want = convert(jax.device_get(jm.init(
        jax.random.PRNGKey(17), ids, vis, ac, mask, segs, **kw)["params"]))
    tm.init_params_threefry(jr.PRNGKey(17))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        if "MAG" in name or "LayerNorm" in name or "layer_norm" in name \
                or name.endswith("bias") and "r_" not in name:
            np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(g, w.numpy(), rtol=NORMAL_RTOL,
                                       atol=0, err_msg=name)


@pytest.fixture(autouse=True, scope="module")
def _jax_threefry():
    """JAX's default stream, threefry2x32, for this module: the JAX
    driver's tests run in process set ``jax_default_prng_impl`` from its
    ``--rng_impl`` flag (default rbg) and a worker runs modules one after
    another."""
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
