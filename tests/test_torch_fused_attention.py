"""The port's packed attention forward against the JAX package's
``fused_attention_packed`` (its Pallas kernel, run in interpret mode on the
CPU), plus the wrapper's checks and the build's failure path.

On the CPU the port takes the kernel's plain PyTorch version; the tests
marked ``cuda`` hold the CUDA kernel itself against that version and skip
without a card. A GPU machine need not have jax installed, so the JAX side
is imported only by the tests that use it, and the card's tests run with
``python -m pytest --noconftest -m cuda tests/test_torch_fused_attention.py``
(``tests/conftest.py`` imports jax).

Tolerances: fp32 1e-5 abs (same math, sums in another order). bf16: both
sides round the probs and the context once from fp32 sums, so an element
may differ by one bf16 rounding: 2^-7 relative plus 2^-6 absolute (a prob
that rounds the other way moves the context by ≲ 2^-9·|v|).
"""

import numpy as np
import pytest
import torch

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as tfa

B, H, S, DH = 3, 2, 50, 16
D = H * DH
SCALE = 1.0 / DH ** 0.5
FP32_ATOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6


def _inputs(b=B, s=S, h=H, dh=DH, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, s, 3 * h * dh).astype(np.float32)
    lengths = rng.randint(1, s + 1, b)
    lengths[0] = 0  # a fully padded row
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return qkv, mask


@pytest.fixture
def jax_fa():
    """The JAX package's jax.numpy and fused_attention module."""
    import jax.numpy as jnp

    from bert_multimodal_transformer_tpu.ops import fused_attention as jfa

    return jnp, jfa


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_packed_forward_matches_jax_kernel(jax_fa, dtype, masked):
    jnp, jfa = jax_fa
    qkv, mask = _inputs()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa.fused_attention_packed(
        jnp.asarray(qkv, jd), jnp.asarray(mask) if masked else None,
        n_heads=H, scale=SCALE)
    got = tfa.fused_attention_packed(
        torch.from_numpy(qkv).to(td),
        torch.from_numpy(mask) if masked else None, n_heads=H, scale=SCALE)
    assert got.dtype == td and tuple(got.shape) == (B, S, D)
    _assert_close(got, want, dtype)


def test_packed_forward_fp32_mask_equals_int_mask():
    qkv, mask = _inputs(seed=1)
    t = torch.from_numpy(qkv)
    a = tfa.fused_attention_packed(t, torch.from_numpy(mask), n_heads=H,
                                   scale=SCALE)
    b = tfa.fused_attention_packed(t, torch.from_numpy(mask).float(),
                                   n_heads=H, scale=SCALE)
    assert torch.equal(a, b)


def test_packed_forward_head_dim_64_matches_jax_kernel(jax_fa):
    """The serving head width (Dh = 64) at a short ragged S."""
    jnp, jfa = jax_fa
    qkv, mask = _inputs(b=2, s=13, h=2, dh=64, seed=2)
    want = jfa.fused_attention_packed(jnp.asarray(qkv), jnp.asarray(mask),
                                      n_heads=2, scale=0.125)
    got = tfa.fused_attention_packed(torch.from_numpy(qkv),
                                     torch.from_numpy(mask), n_heads=2,
                                     scale=0.125)
    _assert_close(got, want, "float32")


def test_dropout_and_saved_probs_raise():
    qkv = torch.zeros(1, 4, 3 * D)
    with pytest.raises(NotImplementedError, match="A.4"):
        tfa.fused_attention_packed(qkv, None, n_heads=H, scale=1.0,
                                   dropout_rate=0.1, deterministic=False)
    with pytest.raises(NotImplementedError, match="A.4"):
        tfa.fused_attention_packed(qkv, None, n_heads=H, scale=1.0,
                                   save_probs=True)
    # deterministic=True turns the rate off, as in the JAX entry
    tfa.fused_attention_packed(qkv, None, n_heads=H, scale=1.0,
                               dropout_rate=0.1, deterministic=True)


def test_long_sequence_raises_naming_the_tiers():
    qkv = torch.zeros(1, tfa.MAX_SEQ_LEN + 1, 3 * D)
    with pytest.raises(NotImplementedError, match="B.4, B.8"):
        tfa.fused_attention_packed(qkv, None, n_heads=H, scale=1.0)


@pytest.mark.parametrize("kw", [{"interpret": True}, {"nb_fwd": 2},
                                {"nb_bwd": 1}])
def test_tpu_plan_knobs_raise(kw):
    with pytest.raises(ValueError, match="TPU"):
        tfa.fused_attention_packed(torch.zeros(1, 4, 3 * D), None,
                                   n_heads=H, scale=1.0, **kw)


def test_bad_geometry_raises():
    with pytest.raises(ValueError, match="3·D"):
        tfa.fused_attention_packed(torch.zeros(1, 4, 10), None, n_heads=H,
                                   scale=1.0)
    with pytest.raises(ValueError, match="divisible"):
        tfa.fused_attention_packed(torch.zeros(1, 4, 3 * 30), None,
                                   n_heads=4, scale=1.0)


def test_cuda_wrapper_refuses_cpu_tensors():
    before = tfa.attn_fwd_packed_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.attn_fwd_packed_cuda(torch.zeros(1, 4, 3 * D), None, n_heads=H,
                                 scale=1.0)
    assert tfa.attn_fwd_packed_cuda.launches == before


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without nvcc the build raises: nothing falls back."""
    monkeypatch.setattr(tfa, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tfa.build_kernels()


def test_failed_compile_raises(tmp_path, monkeypatch):
    """A compiler that exits non-zero makes the build raise with its
    output, and leaves no library behind."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(tfa, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="bad kernel"):
        tfa.build_kernels()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_keyed_by_sources(tmp_path, monkeypatch):
    first = tfa.library_path()
    assert first.parent == tfa._BUILD_DIR
    src = tmp_path / "csrc"
    src.mkdir()
    for f in tfa._sources():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(tfa, "_CSRC", src)
    assert tfa.library_path() == first
    (src / "attn_fwd_packed.cu").write_text("// changed\n")
    assert tfa.library_path() != first


# --- on the card --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,dh", [
    ("bfloat16", 128, 50, 12, 64),   # the serving shape
    ("bfloat16", 8, 512, 12, 64),    # the longest S the kernel takes
    ("float32", 4, 77, 12, 64),
    ("bfloat16", 3, 33, 4, 128),     # the widest head
    ("float32", 2, 5, 3, 8),         # the narrowest head
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, b, s, h, dh):
    qkv, mask = _inputs(b, s, h, dh, seed=3)
    qkv_t = torch.from_numpy(qkv).to(cuda_device, getattr(torch, dtype))
    mask_t = torch.from_numpy(mask).to(cuda_device)
    before = tfa.attn_fwd_packed_cuda.launches
    got = tfa.fused_attention_packed(qkv_t, mask_t, n_heads=h,
                                     scale=1.0 / dh ** 0.5)
    assert tfa.attn_fwd_packed_cuda.launches == before + 1
    want = tfa.fused_attention_packed_reference(qkv_t, mask_t, n_heads=h,
                                                scale=1.0 / dh ** 0.5)
    torch.cuda.synchronize()
    _assert_close(got.cpu(), want.cpu().float().numpy(), dtype)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    qkv = torch.zeros(2, 8, 3 * 64, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        tfa.attn_fwd_packed_cuda(qkv.half(), None, n_heads=1, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.attn_fwd_packed_cuda(qkv.transpose(0, 1), None, n_heads=1,
                                 scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        tfa.attn_fwd_packed_cuda(qkv, None, n_heads=16, scale=1.0)
    with pytest.raises(ValueError, match="attention_mask"):
        tfa.attn_fwd_packed_cuda(qkv, torch.ones(2, 7, device=cuda_device),
                                 n_heads=1, scale=1.0)


@pytest.mark.cuda
def test_failed_launch_raises(cuda_device, monkeypatch):
    """A launch the C side refuses (here an unknown dtype code) comes back
    as its cudaError_t and the wrapper raises; the count does not move."""
    monkeypatch.setitem(tfa._DTYPE_CODES, torch.float32, 7)
    before = tfa.attn_fwd_packed_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        tfa.attn_fwd_packed_cuda(torch.zeros(1, 4, 3 * 64,
                                             device=cuda_device),
                                 None, n_heads=1, scale=1.0)
    assert tfa.attn_fwd_packed_cuda.launches == before
