"""The port's tensor parallelism for MAG-XLNet (``parallel/tp.py``'s XLNet
rules, ``models/xlnet.py``'s head-sharded attention and split FFN, the
rel kernels' counter offsets and ``ops/fused_attention.py``'s
``fused_rel_attention_tp`` / ``fused_rel_attention_ingredients_tp``)
against the JAX package, carrying the XLNet contracts of
``tests/test_tensor_parallel.py``.

Two gloo ranks (CPU processes, ``parallel/mesh.py::run_ranks`` under a
timeout of their own) run every case of the file in one spawn, started
while the JAX reference compiles: at dropout 0 the two-step losses and the
first step's gradients of einsum, fused full-H (#11/#13's plain
versions), fused ingredients (``rel_bias_impl="inkernel"``: #20/#22's) and
the FFN split alone; the dropout steps; ``Predictor(mesh=)``; and the
driver's training under the XLNet TP flags. Both sides start from the same
weights (the JAX params through ``utils/convert.xlnet_params_from_flax``)
and see the same batches, at ``XLNetConfig.tiny()`` (two heads, one a rank)
in fp32.

Tolerances: the losses rtol 1e-5 against the JAX single-device Trainer
(fp32; the model axis sums its partial products in another order); the
first step's gradients against ``jax.grad`` of the same loss, each
parameter's chunk within 1e-5 of its largest gradient; with dropout on,
the TP steps against the port's own one-rank steps at rtol 1e-5 (the rel
kernels' Philox offsets, the head-sliced einsum mask and the FFN dropout
drawn whole and sliced give one card's masks); ``Predictor`` 1e-5; the
offsets' masks and outputs bit for bit.
"""

import argparse
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bert_multimodal_transformer_tpu_torch import driver as tdriver
from bert_multimodal_transformer_tpu_torch.config import (
    MeshConfig,
    MultimodalConfig,
    XLNetConfig,
)
from bert_multimodal_transformer_tpu_torch.data.pipeline import PackedSplit
from bert_multimodal_transformer_tpu_torch.models.xlnet import (
    MagXLNetForSequenceClassification,
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

# (attention_impl, rel_bias_impl, head-sharded attention)
CASES = {"einsum": ("einsum", "auto", True),
         "fused": ("fused", "auto", True),
         "fused_inkernel": ("fused", "inkernel", True),
         "ffn_only": ("fused", "auto", False)}
DROPOUT_CASES = ("einsum", "fused", "fused_inkernel")
DRIVER_ARGV = ["--model", "xlnet-base-cased", "--synthetic", "--tiny",
               "--device", "cpu", "--model_parallel", "2",
               "--tp_shard_attention", "--attention_impl", "fused",
               "--n_epochs", "1", "--train_batch_size", "8",
               "--synthetic_sizes", "16", "8", "8", "--seed", "3"]


def make_batch(seed, n=B):
    """Left-padded rows as the XLNet packing gives them (one row unpadded),
    segment ids 0 on tokens, 2 on <cls>, 3 on pads."""
    rng = np.random.RandomState(seed)
    n_real = rng.randint(3, S + 1, n)
    n_real[0] = S
    real = np.arange(S)[None, :] >= (S - n_real)[:, None]
    segs = np.where(real, 0, 3).astype(np.int32)
    segs[:, -1] = 2
    return (np.where(real, rng.randint(5, V, (n, S)), 2).astype(np.int32),
            (rng.randn(n, S, DV) * real[..., None]).astype(np.float32),
            (rng.randn(n, S, DA) * real[..., None]).astype(np.float32),
            real.astype(np.int32), segs,
            rng.uniform(-3, 3, n).astype(np.float32))


BATCHES = [make_batch(10), make_batch(11)]
SPLIT = PackedSplit(*make_batch(20, n=13))  # a ragged last batch at 8


def _model(impl, rate=0.0, mesh=None, rel_bias_impl="auto"):
    cfg = dataclasses.replace(
        XLNetConfig.tiny(V), attention_impl=impl, dropout=rate,
        summary_last_dropout=rate, rel_bias_impl=rel_bias_impl,
        tp_attention_mesh=mesh)
    return MagXLNetForSequenceClassification(
        cfg, MultimodalConfig(dropout_prob=rate, injection_index=1), DV, DA,
        device="cpu")


def _trainer(model, mesh, shard):
    return ttr.Trainer(model=model, tx=toptim.make_optimizer(LR, 2),
                       mesh=mesh, tp_shard_attention=shard)


def _losses(model, params, mesh=None, shard=False, seed=1):
    """Two train steps on BATCHES from ``params`` (a full state dict)."""
    tr = _trainer(model, mesh, shard)
    st = tr.create_state_from_params(params, seed)
    return [float(tr._train_step(st, tr._put_batch(b))) for b in BATCHES]


def _first_grads(model, params, mesh=None, shard=False):
    """One train step on BATCHES[0]: the gradients it applied, by
    parameter name (this rank's chunks under a mesh)."""
    tr = _trainer(model, mesh, shard)
    st = tr.create_state_from_params(params, 1)
    tr._train_step(st, tr._put_batch(BATCHES[0]))
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()
            if p.grad is not None}


def _two_stream():
    """A perm_mask [B, S, S] (1 = cannot see, the last 3 positions hidden)
    and a target_mapping [B, 3, S] onto them."""
    perm = (np.random.RandomState(5).rand(B, S, S) < 0.3).astype(np.float32)
    perm[:, :, S - 3:] = 1.0
    tm = np.zeros((B, 3, S), np.float32)
    for j in range(3):
        tm[:, j, S - 3 + j] = 1.0
    return torch.from_numpy(perm), torch.from_numpy(tm)


# (config changes, forward keywords): the forward options a head shard
# must serve as one rank does
FORWARD_CASES = {
    "two-stream": ({}, "two_stream"),
    "head_mask and output_attentions": ({}, "head_mask"),
    "bi_data": ({"bi_data": True}, None),
    "uni": ({"attn_type": "uni"}, None),
}


def _forward(params, impl, case, mesh=None):
    """The deterministic forward of FORWARD_CASES[case] on BATCHES[0]
    (head-sharded over ``mesh`` when given): the logits, and the
    attentions gathered whole under ``output_attentions``."""
    changes, kw_case = FORWARD_CASES[case]
    cfg = dataclasses.replace(XLNetConfig.tiny(V), attention_impl=impl,
                              tp_attention_mesh=mesh, **changes)
    model = MagXLNetForSequenceClassification(
        cfg, MultimodalConfig(injection_index=1), DV, DA, device="cpu")
    model.load_state_dict(params)
    if mesh is not None:
        tp.shard_model_(model, mesh, shard_attention=True)
    ids, vis, ac, mask, segs, _ = (torch.from_numpy(a) for a in BATCHES[0])
    kw = dict(attention_mask=mask, token_type_ids=segs)
    if kw_case == "two_stream":
        kw["perm_mask"], kw["target_mapping"] = _two_stream()
    elif kw_case == "head_mask":
        kw["head_mask"] = torch.tensor([1.0, 0.0])
        kw["output_attentions"] = True
    with torch.no_grad():
        out = model(ids, vis, ac, **kw)
    if isinstance(out, tuple):
        return [out[0].numpy()] + [a.numpy() for a in out[1]]
    return [out.numpy()]


def _calls():
    return {name: getattr(tfa, name).calls for name in (
        "attn_fwd_rel_reference", "attn_bwd_rel_saved_reference",
        "attn_fwd_relik_reference", "attn_bwd_relik_saved_reference")}


def _tp_rank(rank, params_np, ckpt_dir):
    """Every case of the file on this rank of a 1×2 mesh; the driver's run
    checkpoints into ``ckpt_dir``."""
    mesh = make_mesh(MeshConfig(data_parallel=-1, model_parallel=2),
                     ["cpu"] * dist.get_world_size())
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    out = {"coords": (mesh.data_rank, mesh.model_rank)}

    def model(case, rate=0.0):
        impl, bias, shard = CASES[case]
        return _model(impl, rate, mesh if shard else None, bias), shard

    for case in CASES:
        before = _calls()
        m, shard = model(case)
        out[case] = _losses(m, params, mesh, shard)
        out[f"{case} calls"] = {k: v - before[k]
                                for k, v in _calls().items()}
        m, shard = model(case)
        out[f"{case} grads"] = _first_grads(m, params, mesh, shard)
    for case in DROPOUT_CASES:
        m, shard = model(case, 0.1)
        out[f"{case} dropout"] = _losses(m, params, mesh, shard, seed=7)
    out["forward"] = {(impl, case): _forward(params, impl, case, mesh)
                      for impl in ("einsum", "fused")
                      for case in FORWARD_CASES}
    m, _ = model("fused")
    m.load_state_dict(params, strict=False)
    out["predict"] = Predictor(m, batch_size=B, mesh=mesh).predict_split(
        SPLIT)
    out["q_chunk"] = m.transformer.layer[0].rel_attn.q.detach().numpy()
    out["gathered"] = {k: v.numpy() for k, v in
                       tp.full_state_dict(m).items()}
    local = tp.local_state_dict(m, params)
    out["local"] = all(torch.equal(local[k], v)
                       for k, v in m.state_dict().items())
    args = tdriver.build_parser().parse_args(
        DRIVER_ARGV + ["--checkpoint_dir", ckpt_dir])
    rc, summary = tdriver._train(args, mesh)
    out["driver"] = (rc, summary["history"])
    return out


# ---- the JAX side ---------------------------------------------------------


def _jax_model():
    from bert_multimodal_transformer_tpu.config import (
        MultimodalConfig as JMultimodalConfig,
        XLNetConfig as JXLNetConfig,
    )
    from bert_multimodal_transformer_tpu.models import xlnet as jxl

    jcfg = dataclasses.replace(JXLNetConfig.tiny(V), dropout=0.0,
                               summary_last_dropout=0.0)
    return jxl.MagXLNetForSequenceClassification(
        jcfg, JMultimodalConfig(dropout_prob=0.0, injection_index=1),
        visual_dim=DV, acoustic_dim=DA)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX tiny MAG-XLNet's params from PRNGKey(0) (no mask_emb: the
    port keeps its own, which no step touches)."""
    import jax

    ids, vis, ac, mask, segs, _ = BATCHES[0]
    return jax.device_get(jax.jit(_jax_model().init)(
        jax.random.PRNGKey(0), ids, vis, ac, attention_mask=mask,
        token_type_ids=segs)["params"])


@pytest.fixture(scope="module")
def full_params(jax_params):
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    params = {k: v.numpy() for k, v in
              xlnet_params_from_flax(jax_params).items()}
    # the query stream's input, which the JAX tree lacks (no
    # target_mapping at init) and no step here reads
    params["transformer.mask_emb"] = np.zeros(
        (1, 1, XLNetConfig.tiny(V).d_model), np.float32)
    return params


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("xlnet_tp_ckpt")


@pytest.fixture(scope="module")
def rank_runs(full_params, ckpt_dir):
    """The two ranks' run, started in the background."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    run = pool.submit(run_ranks, _tp_rank, 2, (full_params, str(ckpt_dir)),
                      timeout_s=RANK_TIMEOUT_S, devices=["cpu"] * 2)
    yield run
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(rank_runs):
    return rank_runs.result()


@pytest.fixture(scope="module")
def jax_reference(jax_params, rank_runs):
    """The JAX single-device Trainer's two losses and ``jax.grad`` of the
    first step's loss (as port names), at dropout 0; computed while the
    ranks run."""
    import jax
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.config import (
        MeshConfig as JMeshConfig,
    )
    from bert_multimodal_transformer_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )
    from bert_multimodal_transformer_tpu.training import optim as joptim
    from bert_multimodal_transformer_tpu.training import trainer as jtrainer
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    jmodel = _jax_model()
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    ids, vis, ac, mask, segs, labels = BATCHES[0]

    def loss(p):
        logits = jmodel.apply({"params": p}, ids, vis, ac,
                              attention_mask=mask, token_type_ids=segs)
        return jnp.mean(jnp.square(logits.reshape(-1) - labels))

    grads = xlnet_params_from_flax(jax.device_get(
        jax.jit(jax.grad(loss))(params)))
    jtr = jtrainer.Trainer(
        model=jmodel, tx=joptim.make_optimizer(LR, 2), donate=False,
        mesh=jmake_mesh(JMeshConfig(data_parallel=1),
                        devices=jax.devices()[:1]))
    st = jtr.create_state_from_params(params, jax.random.PRNGKey(1))
    losses = []
    for b in BATCHES:
        st, value = jtr._train_step(st, jtr._put_batch(b))
        losses.append(float(value))
    return losses, {k: v.numpy() for k, v in grads.items()}


def _fake_mesh(model_rank=0, model=2):
    """A mesh place with no process group (no collective is reached)."""
    return Mesh(data_size=1, model_size=model, rank=model_rank,
                device=torch.device("cpu"), backend=None)


# ---- in this process --------------------------------------------------------


def _halves(fn, n_heads, full_kw, split):
    """``fn`` on all heads, and on each half at its head offset: (the full
    call's outputs, the halves' outputs joined on their head axes)."""
    whole = fn(slice(None), 0, n_heads, full_kw)
    h = n_heads // 2
    parts = [fn(slice(i * h, (i + 1) * h), i * h, h, full_kw)
             for i in range(2)]
    return whole, [split(i, [p[i] for p in parts])
                   for i in range(len(whole))]


def _heads_dim(x, n_heads):
    """The dim of x that holds heads: 1 for [B, H, ...] tensors, else the
    last (head-major flat columns)."""
    return 1 if x.dim() == 4 or (x.dim() == 3 and x.shape[1] == n_heads
                                 ) else x.dim() - 1


@pytest.mark.parametrize("kind", ["rel", "relik", "relik_fs"])
def test_head_halves_at_their_offsets_give_the_one_call_bits(kind):
    """The rel kernels' plain versions with dropout (rate 0.3), forward
    and backward, on the two head halves at ``h_off`` 0 and H/2 (and a
    batch half at ``b_off`` B/2): the full call's keep mask (the saved pd)
    and outputs bit for bit."""
    rng = np.random.RandomState(3)
    b, q_len, k_len, h, dh = 4, 9, 9, 4, 8
    d = h * dh
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(*s).astype(np.float32))
    q, k, v, g = f(b, q_len, d), f(b, k_len, d), f(b, k_len, d), f(
        b, q_len, d)
    ebias, r = f(b, h, q_len, k_len), f(q_len + k_len, d)
    ed = f(b, h, q_len)
    segd = torch.from_numpy((rng.rand(b, q_len, k_len) < 0.5).astype(
        np.float32))
    maskb = torch.zeros(b, q_len, k_len)
    maskb[1, :, :3] = -1e30
    kw = dict(scale=0.35, rate=0.3, seed=123)

    def cols(x, hs):
        return x.reshape(*x.shape[:-1], h, dh)[..., hs, :].flatten(-2)

    def call(hs, h0, nh, kw, rows=slice(None), b0=0):
        off = dict(b_off=b0, h_off=h0)
        qq, kk, vv, gg = (cols(x, hs)[rows] for x in (q, k, v, g))
        if kind == "rel":
            eb = ebias[rows][:, hs]
            out = tfa.attn_fwd_rel_reference(qq, kk, vv, eb, n_heads=nh,
                                             save=True, **off, **kw)
            grads = tfa.attn_bwd_rel_reference(qq, kk, vv, eb, kw["seed"],
                                               gg, n_heads=nh,
                                               scale=kw["scale"],
                                               rate=kw["rate"], **off)
            return (*out, *grads)
        ins = (qq, cols(q * 0.5, hs)[rows], cols(r, hs), kk, vv,
               ed[rows][:, hs], segd[rows], maskb[rows])
        if kind == "relik":
            out = tfa.attn_fwd_relik_reference(*ins, n_heads=nh, save=True,
                                               **off, **kw)
            grads = tfa.attn_bwd_relik_reference(*ins, kw["seed"], gg,
                                                 n_heads=nh,
                                                 scale=kw["scale"],
                                                 rate=kw["rate"], **off)
            return (*out, *grads)
        o, lse = tfa.attn_fwd_relik_fs_reference(*ins, n_heads=nh, **off,
                                                 **kw)
        grads = tfa.attn_bwd_relik_fs_reference(*ins, kw["seed"], o, lse,
                                                gg, n_heads=nh,
                                                scale=kw["scale"],
                                                rate=kw["rate"], **off)
        return (o, lse, *grads)

    whole, halves = _halves(
        lambda hs, h0, nh, kw: call(hs, h0, nh, kw), h, kw,
        lambda i, xs: torch.cat(xs, _heads_dim(xs[0], h // 2)))
    for i, (a, c) in enumerate(zip(whole, halves)):
        assert torch.equal(a, c), (kind, i)
    # a batch half at its row offset, and the mask it would draw at none
    lo = call(slice(None), 0, h, kw, slice(2, 4), 2)
    at0 = call(slice(None), 0, h, kw, slice(2, 4), 0)
    for a, c in zip(whole, lo):
        if a.shape[0] == b:
            assert torch.equal(a[2:], c), kind
    assert not torch.equal(lo[0], at0[0])


def _spec(jspec, ndim, transposed):
    """A JAX PartitionSpec as the port's tuple over ``ndim`` dims."""
    spec = tuple(jspec) + (None,) * (ndim - len(tuple(jspec)))
    return spec[::-1] if transposed else spec


def test_xlnet_pspec_rules_match_jax(jax_params):
    """Every leaf of the tiny model's params: the port's rule on its
    state-dict name equals the JAX rule on its tree path (a Dense kernel's
    spec transposed, as its weight), with and without
    ``shard_attention``."""
    import jax

    from bert_multimodal_transformer_tpu.parallel import tp as jtp
    from bert_multimodal_transformer_tpu_torch.utils.convert import (
        xlnet_params_from_flax,
    )

    leaves = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    split = 0
    for path, leaf in leaves:
        keys = [k.key for k in path]
        tree = leaf
        for key in reversed(keys):
            tree = {key: tree}
        (name,) = xlnet_params_from_flax(tree)
        for shard in (False, True):
            want = _spec(jtp.tp_pspec_for_path(jax.tree_util.keystr(path),
                                               shard_attention=shard),
                         leaf.ndim, keys[-1] == "kernel")
            got = tp.tp_pspec_for_path(name, shard_attention=shard)
            got = got + (None,) * (leaf.ndim - len(got))
            assert got == want, (name, shard, got, want)
            split += MODEL_AXIS in got
    assert split > 20


def test_trainer_refuses_mem_len_under_tp():
    """The JAX trainer's refusal, before anything is sharded."""
    with pytest.raises(ValueError, match="data-parallel trainer"):
        ttr.Trainer(model=_model("einsum"), tx=toptim.make_optimizer(LR, 1),
                    mesh=_fake_mesh(), mem_len=4)


def test_sharded_init_draws_the_one_card_weights():
    """``init_params`` on a head-sharded model draws each split weight
    whole and keeps the chunk: every rank holds what one card would."""
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    single = _model("einsum")
    single.init_params(gen())
    full = single.state_dict()
    for rank in range(2):
        mesh = _fake_mesh(rank)
        model = tp.shard_model_(_model("einsum"), mesh, shard_attention=True)
        model.init_params(gen())
        want = tp.shard_state_dict(full, mesh, True)
        for name, t in model.state_dict().items():
            assert torch.equal(t, want[name]), name


# ---- on the ranks --------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_tp_losses_match_jax_single_device(jax_reference, ranks, case):
    """Model axis 2 at dropout 0: the two-step losses of head-sharded
    einsum, fused full-H (#11/#13's plain versions), fused ingredients
    (#20/#22's) and the FFN split alone equal the JAX single-device
    Trainer's on both ranks, each fused case through its kernels."""
    for r in ranks:
        np.testing.assert_allclose(r[case], jax_reference[0],
                                   rtol=LOSS_RTOL)
        calls = r[f"{case} calls"]
        rel = calls["attn_fwd_rel_reference"]
        relik = calls["attn_fwd_relik_reference"]
        if case == "einsum":
            assert rel == relik == 0
        elif case == "fused_inkernel":
            assert relik > 0 and calls["attn_bwd_relik_saved_reference"] > 0
            assert rel == 0
        else:
            assert rel > 0 and calls["attn_bwd_rel_saved_reference"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_tp_first_step_gradients_match_jax(jax_reference, ranks, case):
    """Each parameter's first-step gradient on each rank equals its chunk
    of ``jax.grad`` of the same loss, within 1e-5 of the chunk's largest
    gradient."""
    want = jax_reference[1]
    for r in ranks:
        got = r[f"{case} grads"]
        assert set(got) == set(want)
        shard = CASES[case][2]
        mesh = _fake_mesh(r["coords"][1])
        for name, g in got.items():
            w = tp.shard_tensor(torch.from_numpy(want[name]),
                                tp.tp_pspec_for_path(
                                    name, shard_attention=shard),
                                mesh).numpy()
            assert g.shape == w.shape, name
            gap = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert gap <= GRAD_TOL, (case, name, gap)


@pytest.mark.parametrize("case", DROPOUT_CASES)
def test_tp_dropout_steps_equal_one_rank(full_params, ranks, case):
    """Dropout on (hidden, FFN, MAG, attention probs 0.1): the two-rank
    steps equal the port's one-rank steps from the same seed."""
    impl, bias, _ = CASES[case]
    params = {k: torch.from_numpy(v) for k, v in full_params.items()}
    want = _losses(_model(impl, 0.1, rel_bias_impl=bias), params, seed=7)
    for r in ranks:
        np.testing.assert_allclose(r[f"{case} dropout"], want,
                                   rtol=LOSS_RTOL)
    assert want[0] != ranks[0][case][0]


@pytest.mark.parametrize("case", list(FORWARD_CASES))
@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_tp_forward_options_match_one_rank(full_params, ranks, impl, case):
    """The forward options on head shards: two-stream attention, a head
    mask that zeroes rank 1's head with the attentions gathered whole,
    ``bi_data``'s per-half position streams and uni attention, each
    equal to the one-rank forward (logits 1e-5; the fused branch takes
    the einsum math where JAX's does)."""
    params = {k: torch.from_numpy(v) for k, v in full_params.items()}
    want = _forward(params, impl, case)
    for r in ranks:
        got = r["forward"][(impl, case)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_predictor_mesh_gathers_the_one_rank_predictions(full_params, ranks):
    model = _model("fused")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in full_params.items()}, strict=False)
    want = Predictor(model, batch_size=B).predict_split(SPLIT)
    for r in ranks:
        np.testing.assert_allclose(r["predict"], want, rtol=1e-5, atol=1e-6)


def test_head_shards_and_the_gathered_state(full_params, ranks, ckpt_dir):
    """Each rank holds its heads' columns of ``q``; the model axis gathers
    the full state dict back and ``local_state_dict`` cuts a rank's chunks
    out of it, so the driver's checkpoint holds full-size tensors."""
    from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    name = "transformer.layer.0.rel_attn.q"
    d = XLNetConfig.tiny(V).d_model
    for m, r in enumerate(ranks):
        np.testing.assert_array_equal(
            r["q_chunk"], full_params[name][:, m * d // 2:(m + 1) * d // 2])
        for k, v in full_params.items():
            np.testing.assert_array_equal(r["gathered"][k], v, err_msg=k)
        assert r["local"]
    saved = CheckpointManager(str(ckpt_dir)).restore_params()
    assert tuple(saved[name].shape) == (d, d)
    assert tuple(saved["transformer.layer.0.ff.layer_1.weight"].shape) == (
        XLNetConfig.tiny(V).d_inner, d)


def test_driver_xlnet_tp_shard_attention_fused_trains(ranks):
    """The driver's training under ``--model xlnet-base-cased
    --model_parallel 2 --tp_shard_attention --attention_impl fused`` on the
    ranks: exit 0, one finite epoch, the same records on both."""
    for r in ranks:
        rc, history = r["driver"]
        assert rc == 0
        (rec,) = history
        assert np.isfinite(rec["train_loss"]) and np.isfinite(
            rec["valid_loss"])
    records = [{k: v for k, v in r["driver"][1][0].items()
                if k != "epoch_seconds"} for r in ranks]
    assert records[0] == records[1]
    assert isinstance(tdriver.build_parser().parse_args(DRIVER_ARGV),
                      argparse.Namespace)


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
