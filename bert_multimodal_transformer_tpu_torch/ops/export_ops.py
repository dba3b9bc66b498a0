"""The port's serving kernels as ``torch.library`` custom ops of one
namespace, ``magtorch``: what a fused serving artifact
(``serving.py::export_forward(keep_attention_impl=True)``) holds in place
of the TPU artifact's ``tpu_custom_call``.

``torch.export`` traces with FakeTensors, which hold no storage: the
kernel entries' direct path, a ctypes launch on ``data_ptr()``, cannot run
in a trace, and a trace on the CPU would record the plain version's aten
ops instead of the kernel. So while ``torch.compiler.is_exporting()`` the
no-grad branch of each entry an export reaches calls ``traced_op(name)``
in place of its kernel or plain version:

* ``attn_fwd_packed`` (#1), ``attn_fwd_packed_hb`` (#4) and
  ``attn_fwd_packed_fs`` (#6, its output alone) from
  ``fused_attention_packed``;
* ``attn_fwd_qkvproj`` (#18, its output alone) from
  ``fused_attention_qkvproj``;
* ``attn_fwd_rel`` (#11), ``attn_fwd_rel_hb`` (#14) and
  ``attn_fwd_rel_fs`` (#16) from ``fused_rel_attention``;
* ``attn_fwd_relik`` (#20) and ``attn_fwd_relik_fs`` (#23) from
  ``fused_rel_attention_ingredients``;
* ``mag_fwd`` (#25) from ``ops/mag_fused.py::mag_gate_fused``.

Each op has three implementations: on CUDA tensors the kernel's ``*_cuda``
wrapper, looked up in its module at call time (a counting wrapper put
there counts the artifact's launches); on CPU tensors its plain version;
and a fake one that gives the output's shape and dtype. Eager calls never
reach the ops, so the dispatcher adds nothing to the eager path.
Importing this module registers the namespace: loading a fused artifact
needs it (``serving.py::load_artifact`` imports it).
"""

from typing import List, Optional

import torch
from torch import Tensor

from bert_multimodal_transformer_tpu_torch.ops import fused_attention as fa
from bert_multimodal_transformer_tpu_torch.ops import mag as mag_ops
from bert_multimodal_transformer_tpu_torch.ops import mag_fused as mf

NAMESPACE = "magtorch"


def _output(result) -> Tensor:
    """The output of an entry that also returns residuals."""
    return result[0] if isinstance(result, tuple) else result


def _register(name: str, plain, cuda, fake) -> None:
    """Op ``magtorch::<name>`` with ``plain`` as its CPU implementation
    (its annotations give the schema), ``cuda`` on CUDA and ``fake``."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", plain,
                                 mutates_args=(), device_types="cpu")
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)


def _packed(name: str) -> None:
    def plain(qkv: Tensor, attention_mask: Optional[Tensor], n_heads: int,
              scale: float) -> Tensor:
        return _output(getattr(fa, f"{name}_reference")(
            qkv, attention_mask, n_heads=n_heads, scale=scale))

    def cuda(qkv, attention_mask, n_heads, scale):
        return _output(getattr(fa, f"{name}_cuda")(
            qkv, attention_mask, n_heads=n_heads, scale=scale))

    def fake(qkv, attention_mask, n_heads, scale):
        b, s, d3 = qkv.shape
        return qkv.new_empty((b, s, d3 // 3))

    _register(name, plain, cuda, fake)


def _rel(name: str) -> None:
    def plain(q: Tensor, k: Tensor, v: Tensor, ebias: Tensor, n_heads: int,
              scale: float) -> Tensor:
        return _output(getattr(fa, f"{name}_reference")(
            q, k, v, ebias, n_heads=n_heads, scale=scale))

    def cuda(q, k, v, ebias, n_heads, scale):
        return _output(getattr(fa, f"{name}_cuda")(
            q, k, v, ebias, n_heads=n_heads, scale=scale))

    def fake(q, k, v, ebias, n_heads, scale):
        return torch.empty_like(q)

    _register(name, plain, cuda, fake)


def _relik(name: str) -> None:
    def plain(rw: Tensor, rr: Tensor, r: Tensor, k: Tensor, v: Tensor,
              ed: Tensor, segd: Tensor, maskb: Tensor, n_heads: int,
              scale: float) -> Tensor:
        return _output(getattr(fa, f"{name}_reference")(
            rw, rr, r, k, v, ed, segd, maskb, n_heads=n_heads, scale=scale))

    def cuda(rw, rr, r, k, v, ed, segd, maskb, n_heads, scale):
        return _output(getattr(fa, f"{name}_cuda")(
            rw, rr, r, k, v, ed, segd, maskb, n_heads=n_heads, scale=scale))

    def fake(rw, rr, r, k, v, ed, segd, maskb, n_heads, scale):
        return torch.empty_like(rw)

    _register(name, plain, cuda, fake)


def _qkvproj() -> None:
    def plain(x: Tensor, w: Tensor, b3: Tensor,
              attention_mask: Optional[Tensor], n_heads: int,
              scale: float) -> Tensor:
        return fa.attn_fwd_qkvproj_reference(
            x, w, b3, attention_mask, n_heads=n_heads, scale=scale)[0]

    def cuda(x, w, b3, attention_mask, n_heads, scale):
        return fa.attn_fwd_qkvproj_cuda(
            x, w, b3, attention_mask, n_heads=n_heads, scale=scale)[0]

    def fake(x, w, b3, attention_mask, n_heads, scale):
        return torch.empty_like(x)

    _register("attn_fwd_qkvproj", plain, cuda, fake)


def _mag() -> None:
    def plain(text: Tensor, visual: Tensor, acoustic: Tensor,
              params: List[Tensor], beta_shift: float) -> Tensor:
        return mag_ops.mag_gate(dict(zip(mf.PARAM_NAMES, params)), text,
                                visual, acoustic, beta_shift=beta_shift)

    def cuda(text, visual, acoustic, params, beta_shift):
        return mf.mag_fwd_cuda(dict(zip(mf.PARAM_NAMES, params)), text,
                               visual, acoustic, beta_shift=beta_shift)

    def fake(text, visual, acoustic, params, beta_shift):
        return torch.empty_like(text)

    _register("mag_fwd", plain, cuda, fake)


PACKED_OPS = ("attn_fwd_packed", "attn_fwd_packed_hb", "attn_fwd_packed_fs")
REL_OPS = ("attn_fwd_rel", "attn_fwd_rel_hb", "attn_fwd_rel_fs")
RELIK_OPS = ("attn_fwd_relik", "attn_fwd_relik_fs")
for _name in PACKED_OPS:
    _packed(_name)
for _name in REL_OPS:
    _rel(_name)
for _name in RELIK_OPS:
    _relik(_name)
del _name
_qkvproj()
_mag()


def traced_op(name: str, rate: float = 0.0):
    """The op an entry calls while ``torch.export`` traces it. An exported
    program is the deterministic forward: a rate > 0 raises."""
    if rate > 0.0:
        raise ValueError(
            f"{name}: an exported program is the deterministic forward; "
            f"dropout (rate {rate}) is not traced into it")
    return getattr(getattr(torch.ops, NAMESPACE), name)


def ops_in(program) -> List[str]:
    """The ``magtorch`` ops an exported program's graph calls, one entry
    per call, in graph order."""
    prefix = f"{NAMESPACE}."
    return [str(n.target)[len(prefix):].split(".")[0]
            for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith(prefix)]
