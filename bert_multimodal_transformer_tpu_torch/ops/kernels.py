"""Build and bind the port's CUDA kernels (every ``csrc/*.cu``) as one shared
library with a plain C interface, and launch them.

``build_kernels`` compiles the sources with nvcc (one process per source,
all started together, then one link) into ``build/torch_kernels/``, keyed
by a hash of every ``csrc/*.cu``/``*.cuh`` and the flags, at first use.
``load_kernels`` loads it with ctypes and declares every entry's argument
types. ``launch`` calls one entry on PyTorch's current stream and raises
with the library's error string when the launch is refused. Nothing here
runs when the module is imported: the CPU tests import every module.
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

# The dtype codes every entry takes for its activations.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Largest dynamic shared memory a block may opt into on sm_90 (227 KB).
MAX_SMEM_BYTES = 232448

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None


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
    """Every kernel source and header (what the library's hash covers)."""
    return sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")])


def library_path() -> Path:
    """Where the shared library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD_DIR / f"libtorch_kernels_{digest.hexdigest()[:16]}.so"


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into one shared library unless a build of the
    same sources and flags exists: one nvcc process per source, all
    started together, then one link. nvcc's output (``-Xptxas -v``: each
    kernel's registers, shared memory and spills) is kept beside the
    library as ``.log``. Raises if any step fails."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    tmp = lib_path.with_name(f"{tag}.tmp")
    jobs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = _BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed with exit code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    lib_path.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, lib_path)
    return lib_path


def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, with every
    argument type declared: a pointer or stream passed without
    ``c_void_p`` would be cut to 32 bits."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernels()))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        u64, u32 = ctypes.c_ulonglong, ctypes.c_uint
        dims = [i32, i32, i32, i32, f32]          # B, S, H, Dh, scale
        drop = [i32, u64, u32, f32]               # on, seed, thresh, inv_keep
        mag = [i32, i32, i32, i32, f32]           # N, D, Dv, Da, beta_shift
        lib.attn_fwd_packed.argtypes = ([ptr] * 5 + dims + drop
                                        + [i32, ptr])
        lib.attn_bwd_packed.argtypes = [ptr] * 4 + dims + drop + [i32, ptr]
        lib.attn_bwd_packed_saved.argtypes = [ptr] * 5 + dims + [i32, ptr]
        # attn_fwd_packed_hb: qkv, mask, out; attn_bwd_packed_hb{,_dkdv}:
        # qkv, mask, g, dqkv, ws; attn_fwd_packed_fs: qkv, mask, out, lse;
        # attn_bwd_packed_fs_{dkdv,dq}: qkv, mask, o, lse, g, dqkv.
        lib.attn_fwd_packed_hb.argtypes = [ptr] * 3 + dims + drop + [i32, ptr]
        for fn in (lib.attn_bwd_packed_hb, lib.attn_bwd_packed_hb_dkdv):
            fn.argtypes = [ptr] * 5 + dims + drop + [i32, ptr]
        lib.attn_fwd_packed_fs.argtypes = [ptr] * 4 + dims + drop + [i32, ptr]
        for fn in (lib.attn_bwd_packed_fs_dkdv, lib.attn_bwd_packed_fs_dq):
            fn.argtypes = [ptr] * 6 + dims + drop + [i32, ptr]
        # attn_fwd_split: q, k, v, mask, out, p, pd; attn_bwd_split: q, k,
        # v, mask, g, dq, dk, dv; both then b_off, h_off after the dropout
        # args; attn_bwd_split_saved: p, pd, q, k, v, g, dq, dk, dv.
        offs = [i32, i32]                         # b_off, h_off
        lib.attn_fwd_split.argtypes = ([ptr] * 7 + dims + drop + offs
                                       + [i32, ptr])
        lib.attn_bwd_split.argtypes = ([ptr] * 8 + dims + drop + offs
                                       + [i32, ptr])
        lib.attn_bwd_split_saved.argtypes = [ptr] * 9 + dims + [i32, ptr]
        # attn_fwd_qkvproj: x, w, b3, mask, out, qkv_out, p, pd;
        # attn_bwd_qkvproj_heads: p, pd, src, w, b3, g, dqkv, then dims and
        # recompute; attn_bwd_qkvproj_dx: dqkv, w, dx, M, D.
        lib.attn_fwd_qkvproj.argtypes = [ptr] * 8 + dims + drop + [i32, ptr]
        lib.attn_bwd_qkvproj_heads.argtypes = ([ptr] * 7 + dims
                                               + [i32, i32, ptr])
        lib.attn_bwd_qkvproj_dx.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        rel = [i32, i32, i32, i32, i32, f32]      # B, Q, K, H, Dh, scale
        # attn_fwd_rel: q, k, v, ebias, out, p, pd; attn_bwd_rel: q, k, v,
        # ebias, g, dq, dk, dv, debias; attn_bwd_rel_saved: p, pd, q, k, v,
        # g, dq, dk, dv, debias.
        lib.attn_fwd_rel.argtypes = [ptr] * 7 + rel + drop + [i32, ptr]
        lib.attn_bwd_rel.argtypes = [ptr] * 9 + rel + drop + [i32, ptr]
        lib.attn_bwd_rel_saved.argtypes = [ptr] * 10 + rel + [i32, ptr]
        # attn_fwd_rel_hb: q, k, v, ebias, out; attn_bwd_rel_hb: q, k, v,
        # ebias, g, dq, dk, dv, debias, ws.
        lib.attn_fwd_rel_hb.argtypes = [ptr] * 5 + rel + drop + [i32, ptr]
        lib.attn_bwd_rel_hb.argtypes = [ptr] * 10 + rel + drop + [i32, ptr]
        # attn_fwd_rel_fs: q, k, v, ebias, out, lse; attn_bwd_rel_fs_{dkdv,
        # dq}: q, k, v, ebias, o, lse, g, dq, dk, dv, debias.
        lib.attn_fwd_rel_fs.argtypes = [ptr] * 6 + rel + drop + [i32, ptr]
        for fn in (lib.attn_bwd_rel_fs_dkdv, lib.attn_bwd_rel_fs_dq):
            fn.argtypes = [ptr] * 11 + rel + drop + [i32, ptr]
        # attn_fwd_relik_fs: rw, rr, r, k, v, ed, segd, maskb, out, lse;
        # attn_bwd_relik_fs_{dkdv,dq}: the eight inputs, o, lse, g, drw, drr,
        # dk, dv, ded, ws; attn_bwd_relik_fs_dr: ws, dr, B, P, D.
        relik = [i32] * 6 + [f32]                 # B, Q, K, P, H, Dh, scale
        lib.attn_fwd_relik_fs.argtypes = ([ptr] * 10 + relik + drop
                                          + [i32, ptr])
        for fn in (lib.attn_bwd_relik_fs_dkdv, lib.attn_bwd_relik_fs_dq):
            fn.argtypes = [ptr] * 17 + relik + drop + [i32, ptr]
        lib.attn_bwd_relik_fs_dr.argtypes = [ptr] * 2 + [i32] * 4 + [ptr]
        # attn_fwd_relik: the eight inputs, out, p, pd; attn_bwd_relik: the
        # eight inputs, g, drw, drr, dk, dv, ded, ws; attn_bwd_relik_saved:
        # p, pd, rw, rr, r, k, v, segd, g, drw, drr, dk, dv, ded, ws.
        lib.attn_fwd_relik.argtypes = [ptr] * 11 + relik + drop + [i32, ptr]
        lib.attn_bwd_relik.argtypes = [ptr] * 15 + relik + drop + [i32, ptr]
        lib.attn_bwd_relik_saved.argtypes = [ptr] * 15 + relik + [i32, ptr]
        # mag_fwd: t, v, a, 12 params, out; mag_bwd: dy, t, v, a, 11
        # params (no ln_beta), 6 outputs.
        lib.mag_fwd.argtypes = [ptr] * 16 + mag + [i32, ptr]
        lib.mag_bwd.argtypes = [ptr] * 21 + mag + [i32, ptr]
        for fn in (lib.attn_fwd_packed, lib.attn_bwd_packed,
                   lib.attn_bwd_packed_saved, lib.attn_fwd_packed_hb,
                   lib.attn_bwd_packed_hb, lib.attn_bwd_packed_hb_dkdv,
                   lib.attn_fwd_packed_fs,
                   lib.attn_bwd_packed_fs_dkdv, lib.attn_bwd_packed_fs_dq,
                   lib.attn_fwd_split, lib.attn_bwd_split,
                   lib.attn_bwd_split_saved, lib.attn_fwd_qkvproj,
                   lib.attn_bwd_qkvproj_heads, lib.attn_bwd_qkvproj_dx,
                   lib.attn_fwd_rel, lib.attn_bwd_rel,
                   lib.attn_bwd_rel_saved, lib.attn_fwd_rel_hb,
                   lib.attn_bwd_rel_hb, lib.attn_fwd_rel_fs,
                   lib.attn_bwd_rel_fs_dkdv, lib.attn_bwd_rel_fs_dq,
                   lib.attn_fwd_relik_fs,
                   lib.attn_bwd_relik_fs_dkdv, lib.attn_bwd_relik_fs_dq,
                   lib.attn_bwd_relik_fs_dr, lib.attn_fwd_relik,
                   lib.attn_bwd_relik, lib.attn_bwd_relik_saved, lib.mag_fwd,
                   lib.mag_bwd):
            fn.restype = ctypes.c_int
        lib.torch_kernels_error_string.argtypes = [i32]
        lib.torch_kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(fn_name: str, *args, device) -> None:
    """Call entry ``fn_name`` of the library with ``args`` and the current
    stream of ``device``; raise if it returns a CUDA error."""
    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        msg = lib.torch_kernels_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")


def check_sm90(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a card the library was built for."""
    if torch.cuda.get_device_capability(t.device) != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a; {t.device} is "
            f"{torch.cuda.get_device_name(t.device)}")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()
