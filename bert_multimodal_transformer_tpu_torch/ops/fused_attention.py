"""Packed attention forward (port of ``ops/fused_attention.py``'s
``fused_attention_packed`` full-H tier, serving form: no dropout, no saved
probs).

Three pieces live here:

* ``fused_attention_packed_reference``: the plain PyTorch version of the
  kernel's math. CPU tensors take it; the tests and ``chip_smoke.py`` hold
  the kernel against it.
* ``attn_fwd_packed_cuda``: the wrapper that launches the hand-written CUDA
  kernel ``csrc/attn_fwd_packed.cu`` on PyTorch's current stream. It
  counts its launches in ``attn_fwd_packed_cuda.launches``.
* ``load_kernels``: builds ``csrc/*.cu`` with nvcc into a shared library
  with a plain C interface (``build/torch_kernels/``, keyed by a hash of
  the sources and flags) at first use, and binds it with ctypes.

``fused_attention_packed`` dispatches on the tensor's device: a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

# Longest sequence the kernel's shared-memory plan takes
# (max_position_embeddings of bert-base).
MAX_SEQ_LEN = 512
MAX_HEAD_DIM = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None


def fused_attention_packed_reference(
    qkv: torch.Tensor,                        # [B, S, 3·D]
    attention_mask: Optional[torch.Tensor],   # [B, S], 1 = real token
    *,
    n_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch version of the packed forward: fp32 scores (scale
    after the dot, then the (1−m)·−10000 bias), fp32 softmax, probs
    rounded to the input dtype, PV accumulated in fp32, output in the
    input dtype. Returns [B, S, D]."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    q, k, v = qkv.reshape(b, s, 3, n_heads, dh).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if attention_mask is not None:
        bias = (1.0 - attention_mask.float()) * -10000.0
        scores = scores + bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    ctx = torch.matmul(probs.float(), v.float()).to(qkv.dtype)
    return ctx.permute(0, 2, 1, 3).reshape(b, s, d)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the shared library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD_DIR / f"libtorch_kernels_{digest.hexdigest()[:16]}.so"


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into one shared library unless a build of the
    same sources and flags exists. nvcc's output (``-Xptxas -v``: each
    kernel's registers, shared memory and spills) is kept beside the
    library as ``.log``. Raises if the build fails."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, with every
    argument type declared: a pointer or stream passed without
    ``c_void_p`` would be cut to 32 bits."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernels()))
        fn = lib.attn_fwd_packed
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err_str = lib.attn_fwd_packed_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def attn_fwd_packed_cuda(
    qkv: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    *,
    n_heads: int,
    scale: float,
) -> torch.Tensor:
    """Launch ``csrc/attn_fwd_packed.cu`` on ``qkv`` [B, S, 3·D] (CUDA,
    fp32 or bf16, contiguous). Raises on anything the kernel does not
    take and on a failed launch; never falls back."""
    if not qkv.is_cuda:
        raise ValueError(f"qkv must be a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"qkv dtype {qkv.dtype} not supported (float32, bfloat16)")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(
            f"qkv must be a contiguous [B, S, 3·D] tensor, got shape "
            f"{tuple(qkv.shape)} contiguous={qkv.is_contiguous()}")
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    if dh % 8 != 0 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {dh} not supported (a multiple of 8 up to "
            f"{MAX_HEAD_DIM})")
    if s > MAX_SEQ_LEN:
        raise ValueError(f"S={s} exceeds the kernel's {MAX_SEQ_LEN}")
    if b > 65535 or n_heads > 65535:
        raise ValueError(f"B={b} or H={n_heads} exceeds a grid dimension")
    if torch.cuda.get_device_capability(qkv.device) != (9, 0):
        raise RuntimeError(
            f"the kernel is built for sm_90a; {qkv.device} is "
            f"{torch.cuda.get_device_name(qkv.device)}")
    mask_ptr = None
    if attention_mask is not None:
        if attention_mask.shape != (b, s):
            raise ValueError(
                f"attention_mask shape {tuple(attention_mask.shape)} != "
                f"{(b, s)}")
        if attention_mask.device != qkv.device:
            raise ValueError("attention_mask and qkv on different devices")
        attention_mask = attention_mask.to(torch.float32).contiguous()
        mask_ptr = attention_mask.data_ptr()
    lib = load_kernels()
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attn_fwd_packed(
            qkv.data_ptr(), mask_ptr, out.data_ptr(), b, s, n_heads, dh,
            float(scale), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        msg = lib.attn_fwd_packed_error_string(err).decode()
        raise RuntimeError(f"attn_fwd_packed launch failed: {msg} ({err})")
    attn_fwd_packed_cuda.launches += 1
    return out


attn_fwd_packed_cuda.launches = 0


def fused_attention_packed(
    qkv: torch.Tensor,                        # [B, S, 3·D]
    attention_mask: Optional[torch.Tensor],   # [B, S] {0,1}, 1 = real token
    *,
    n_heads: int,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_rng=None,
    deterministic: bool = True,
    interpret: Optional[bool] = None,
    nb_fwd: Optional[int] = None,
    nb_bwd: Optional[int] = None,
    save_probs: Optional[bool] = None,
) -> torch.Tensor:
    """Attention on the packed QKV projection (column packing
    ``reshape(B, S, 3, H, Dh)``), returning the context as [B, S, D].

    Same signature as the JAX entry. Only its serving form is ported:
    prob dropout and the saved-probs residual belong to the training slice
    (ROADMAP A.4), and ``interpret``/``nb_fwd``/``nb_bwd`` are TPU plan
    knobs with no meaning here; each raises when asked for. Sequences past
    ``MAX_SEQ_LEN`` need the head-blocked or flash-streamed tiers
    (ROADMAP B.4, B.8) and raise too.
    """
    rate = 0.0 if deterministic else float(dropout_rate)
    if rate > 0.0 or dropout_rng is not None or save_probs:
        raise NotImplementedError(
            "prob dropout and saved probs belong to the training slice "
            "(ROADMAP A.4)")
    if interpret is not None or nb_fwd is not None or nb_bwd is not None:
        raise ValueError(
            "interpret/nb_fwd/nb_bwd are TPU kernel-plan knobs; the CUDA "
            "kernel takes none")
    b, s, d3 = qkv.shape
    if d3 % 3 != 0:
        raise ValueError(f"packed QKV last dim must be 3·D, got {d3}")
    d = d3 // 3
    if d % n_heads != 0:
        raise ValueError(
            f"hidden dim {d} not divisible by n_heads={n_heads}")
    if s > MAX_SEQ_LEN:
        raise NotImplementedError(
            f"S={s} > {MAX_SEQ_LEN}: the head-blocked and flash-streamed "
            "attention tiers are not ported yet (ROADMAP B.4, B.8)")
    if qkv.is_cuda:
        return attn_fwd_packed_cuda(qkv, attention_mask, n_heads=n_heads,
                                    scale=scale)
    if qkv.device.type != "cpu":
        raise ValueError(
            f"fused_attention_packed runs on CUDA or CPU tensors, got "
            f"{qkv.device}")
    return fused_attention_packed_reference(
        qkv, attention_mask, n_heads=n_heads, scale=scale)
