"""Fused MAG gate, forward and backward (port of ``ops/mag_pallas.py``).

Two kernels, each with its plain PyTorch version beside it:

* #25 ``mag_fwd_cuda`` → ``csrc/mag_fwd.cu``, plain version
  ``ops/mag.py::mag_gate``: the whole gate per row, the math of the TPU
  ``_mag_kernel``. In bf16 its six products run on the tensor cores
  (``csrc/mag_tc.cuh``): each fp32 weight split into three bf16 planes
  as it arrives (together they hold it to 2^-24 of itself, and a bf16
  activation times a bf16 plane is exact in fp32), 64 rows × 128 columns
  a block, the D / 128 blocks of a row block in a thread block cluster
  that trades the row sums; in fp32 they run on the CUDA cores
  (``csrc/mag_common.cuh``);
* #26 ``mag_bwd_cuda`` → ``csrc/mag_bwd.cu``, plain version
  ``mag_bwd_chain_plain``: the TPU ``_mag_bwd_kernel``'s chain (recompute,
  LayerNorm backward, α / norm-clamp backward, gate / ReLU backward),
  emitting dpv, dpa, ddv, dda, the text partial and x̂, each [N, D] fp32.

``grads_from_chain`` turns the chain into the weight and input gradients
as plain fp32 products and sums, as ``_mag_backward_pallas`` leaves them to
XLA at ``Precision.HIGHEST`` (PyTorch's fp32 products run in full fp32
unless a caller turns TF32 on); ``mag_backward`` is the chain and then
those. ``MagGateFused`` is the autograd function (the JAX ``custom_vjp``):
it saves (params, text, visual, acoustic) and its backward runs
``mag_backward``. Plain gradients come from a model built with
``use_fused_kernel=False``.

``mag_gate_fused`` is the entry. A CUDA tensor launches the kernels or
raises; a CPU tensor takes the plain versions. The kernels take any text
width D up to ``MAX_D`` (bert-large's 1024) and the true modality widths:
the TPU's 128-lane padding and its ``d % 128`` fallback have no
counterpart here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from bert_multimodal_transformer_tpu_torch.ops import mag as mag_ops
from bert_multimodal_transformer_tpu_torch.ops.kernels import (
    DTYPE_CODES,
    MAX_SMEM_BYTES,
    check_sm90,
    launch,
)

# The order in which the kernels take the params.
PARAM_NAMES = ("w_hv_v", "w_hv_t", "b_hv", "w_ha_a", "w_ha_t", "b_ha",
               "w_v", "b_v", "w_a", "b_a", "ln_gamma", "ln_beta")
MAX_D = 1024
LN_EPS = 1e-5
# csrc/mag_common.cuh: rows per block, and the weight rows fetched ahead.
_ROWS, _K_STEP = 16, 8
# csrc/mag_tc.cuh (bf16 #25): a block's rows and columns, the ring's slice
# depth and stages.
TC_ROWS, TC_COLS, TC_SLICE, TC_STAGES = 64, 128, 32, 3


def smem_bytes(d: int, dv: int, da: int) -> int:
    """Shared memory of one block of the CUDA-core plan (#26, fp32 #25;
    ``mag_common.cuh``'s ``smem_floats``): H_m [16][D], and t, v and a
    [16][width] with each width rounded up to a multiple of 8, in fp32.
    The wrappers admit the shapes it fits in both dtypes."""
    def padded(w):
        return -(-w // _K_STEP) * _K_STEP

    return 4 * _ROWS * (padded(d) + d + padded(dv) + padded(da))


def tc_smem_bytes() -> int:
    """Shared memory of one block of bf16 #25's tensor-core plan
    (``mag_tc.cuh``'s ``smem_bytes``): the ring, TC_STAGES × (the
    activations [64][TC_SLICE + 8] bf16 and the weights [TC_SLICE][TC_COLS
    + 4] fp32), the H_m tile [64][TC_COLS + 4] fp32 and the three [64][2]
    fp32 rows of partial sums: 101376 bytes whatever D, Dv and Da."""
    stage = (TC_ROWS * (TC_SLICE + 8) * 2
             + TC_SLICE * (TC_COLS + 4) * 4)
    return (TC_STAGES * stage + TC_ROWS * (TC_COLS + 4) * 4
            + 3 * TC_ROWS * 2 * 4)



def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def _weights(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: params[k].to(torch.float32) for k in PARAM_NAMES}


# ---- plain PyTorch versions -----------------------------------------------


def _recompute(w, t, v, a, beta_shift: float):
    """The forward intermediates of ``_mag_kernel`` / ``_mag_bwd_kernel``
    on fp32 rows t [N, D], v [N, Dv], a [N, Da]."""
    pv = v @ w["w_hv_v"] + t @ w["w_hv_t"] + w["b_hv"]
    pa = a @ w["w_ha_a"] + t @ w["w_ha_t"] + w["b_ha"]
    gate_v, gate_a = torch.relu(pv), torch.relu(pa)
    dv_ = v @ w["w_v"] + w["b_v"]
    da_ = a @ w["w_a"] + w["b_a"]
    h_m = gate_v * dv_ + gate_a * da_
    em = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
    hn = torch.sqrt(torch.sum(h_m * h_m, dim=-1, keepdim=True))
    hn1 = torch.where(hn == 0.0, 1.0, hn)
    thresh = (em / (hn1 + mag_ops.EPS)) * beta_shift
    alpha = torch.clamp(thresh, max=1.0)
    fused = alpha * h_m + t
    mu = fused.mean(dim=-1, keepdim=True)
    c = fused - mu
    inv = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + LN_EPS)
    return dict(pv=pv, pa=pa, gate_v=gate_v, gate_a=gate_a, dv_=dv_,
                da_=da_, h_m=h_m, em=em, hn=hn, hn1=hn1, thresh=thresh,
                alpha=alpha, xhat=c * inv, inv=inv)


def clamp_vjp(thresh: torch.Tensor) -> torch.Tensor:
    """d min(thresh, 1) / d thresh as ``jnp.minimum``'s VJP takes it: 1
    below the tie, 0.5 at thresh == 1, 0 above."""
    return torch.where(thresh < 1.0, 1.0,
                       torch.where(thresh == 1.0, 0.5, 0.0))


def mag_bwd_chain_plain(params, text, visual, acoustic, dy, *,
                        beta_shift: float = 1.0) -> Tuple[torch.Tensor, ...]:
    """Plain version of kernel #26 on rows text/dy [N, D], visual [N, Dv],
    acoustic [N, Da]: (dpv, dpa, ddv, dda, dt_partial, xhat), [N, D] fp32.
    min's VJP is 0.5 at the tie thresh == 1 (``jnp.minimum``'s; torch's
    clamp gives 1 there); ‖H_m‖ = 0 passes no gradient to the norm and
    ‖t‖ = 0 none to t, as the TPU kernel."""
    f32 = torch.float32
    w = _weights(params)
    t = text.to(f32)
    r = _recompute(w, t, visual.to(f32), acoustic.to(f32), beta_shift)
    xhat, inv, h_m = r["xhat"], r["inv"], r["h_m"]
    # LayerNorm backward
    dxh = dy.to(f32) * w["ln_gamma"]
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    df = inv * (dxh - m1 - xhat * m2)
    # α / norm-clamp backward
    dalpha = torch.sum(df * h_m, dim=-1, keepdim=True)
    thresh, em, hn, hn1 = r["thresh"], r["em"], r["hn"], r["hn1"]
    dthresh = dalpha * clamp_vjp(thresh)
    dem = dthresh * beta_shift / (hn1 + mag_ops.EPS)
    dhn1 = (-dthresh * beta_shift * em
            / ((hn1 + mag_ops.EPS) * (hn1 + mag_ops.EPS)))
    live = (hn != 0.0).to(f32)
    dhn = dhn1 * live
    em_safe = torch.where(em == 0.0, 1.0, em)
    dt_norm = (dem / em_safe) * torch.where(em == 0.0, 0.0, 1.0) * t
    dhm = r["alpha"] * df + (dhn / hn1) * live * h_m
    # gate / displacement backward
    dpv = dhm * r["dv_"] * (r["pv"] > 0.0).to(f32)
    dpa = dhm * r["da_"] * (r["pa"] > 0.0).to(f32)
    ddv = dhm * r["gate_v"]
    dda = dhm * r["gate_a"]
    return dpv, dpa, ddv, dda, df + dt_norm, xhat


# ---- CUDA wrappers ----------------------------------------------------------


def _check_cuda(name: str, text, visual, acoustic, params, dy=None):
    """The checks both wrappers make; returns (n, d, dv, da)."""
    if not text.is_cuda:
        raise ValueError(f"{name}: text must be a CUDA tensor, got "
                         f"{text.device}")
    if text.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {text.dtype} not supported "
                         "(float32, bfloat16)")
    acts = [("text", text), ("visual", visual), ("acoustic", acoustic)]
    if dy is not None:
        acts.append(("dy", dy))
    lead = tuple(text.shape[:-1])
    for label, x in acts:
        if (x.device != text.device or x.dtype != text.dtype
                or not x.is_contiguous() or x.dim() < 1
                or tuple(x.shape[:-1]) != lead):
            raise ValueError(
                f"{name}: {label} must be a contiguous {text.dtype} tensor "
                f"on {text.device} with leading shape {lead}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device} "
                f"contiguous={x.is_contiguous()}")
    d, dv, da = text.shape[-1], visual.shape[-1], acoustic.shape[-1]
    if dy is not None and dy.shape[-1] != d:
        raise ValueError(f"{name}: dy width {dy.shape[-1]} != {d}")
    if not (1 <= d <= MAX_D and dv >= 1 and da >= 1):
        raise ValueError(f"{name}: D={d} must be in [1, {MAX_D}], Dv={dv} "
                         f"and Da={da} at least 1")
    if smem_bytes(d, dv, da) > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: D={d}, Dv={dv}, Da={da} need {smem_bytes(d, dv, da)} "
            f"bytes of shared memory a block, over {MAX_SMEM_BYTES}")
    shapes = {"w_hv_v": (dv, d), "w_hv_t": (d, d), "w_ha_a": (da, d),
              "w_ha_t": (d, d), "w_v": (dv, d), "w_a": (da, d)}
    for k in PARAM_NAMES:
        if k == "ln_beta" and dy is not None:
            continue
        p = params[k]
        want = shapes.get(k, (d,))
        if (p.dtype != torch.float32 or p.device != text.device
                or not p.is_contiguous() or tuple(p.shape) != want):
            raise ValueError(
                f"{name}: param {k} must be a contiguous float32 tensor of "
                f"shape {want} on {text.device}, got {p.dtype} "
                f"{tuple(p.shape)} on {p.device}")
    check_sm90(text)
    n = text.numel() // d
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"{name}: {n} rows; the kernel takes 1 to 2^31 - 1")
    return n, d, dv, da


def mag_fwd_cuda(params, text, visual, acoustic, *,
                 beta_shift: float = 1.0) -> torch.Tensor:
    """Launch kernel #25 (``csrc/mag_fwd.cu``): text [..., D], visual
    [..., Dv] and acoustic [..., Da] (CUDA, one dtype of fp32 / bf16,
    contiguous), the params fp32. Returns the gate's output in
    ``text.dtype``. Raises on anything the kernel does not take and on a
    failed launch; never falls back."""
    n, d, dv, da = _check_cuda("mag_fwd", text, visual, acoustic, params)
    out = torch.empty_like(text)
    launch("mag_fwd", text.data_ptr(), visual.data_ptr(),
           acoustic.data_ptr(), *(params[k].data_ptr() for k in PARAM_NAMES),
           out.data_ptr(), n, d, dv, da, float(beta_shift),
           DTYPE_CODES[text.dtype], device=text.device)
    mag_fwd_cuda.launches += 1
    return out


def mag_bwd_cuda(params, text, visual, acoustic, dy, *,
                 beta_shift: float = 1.0) -> Tuple[torch.Tensor, ...]:
    """Launch kernel #26 (``csrc/mag_bwd.cu``) on rows text/dy [N, D],
    visual [N, Dv], acoustic [N, Da] (one dtype, contiguous): returns
    (dpv, dpa, ddv, dda, dt_partial, xhat), [N, D] fp32."""
    n, d, dv, da = _check_cuda("mag_bwd", text, visual, acoustic, params,
                               dy)
    outs = tuple(torch.empty((n, d), dtype=torch.float32, device=text.device)
                 for _ in range(6))
    launch("mag_bwd", dy.data_ptr(), text.data_ptr(), visual.data_ptr(),
           acoustic.data_ptr(),
           *(params[k].data_ptr() for k in PARAM_NAMES[:-1]),
           *(o.data_ptr() for o in outs), n, d, dv, da, float(beta_shift),
           DTYPE_CODES[text.dtype], device=text.device)
    mag_bwd_cuda.launches += 1
    return outs


mag_fwd_cuda.launches = 0
mag_bwd_cuda.launches = 0


# ---- device dispatch, backward and autograd ---------------------------------


def _on(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mag_gate_fused runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return x.device.type


def mag_fwd(params, text, visual, acoustic, *, beta_shift):
    """Kernel #25 on a CUDA tensor, its plain version on a CPU one."""
    fn = mag_fwd_cuda if _on(text) == "cuda" else mag_ops.mag_gate
    return fn(params, text, visual, acoustic, beta_shift=beta_shift)


def mag_bwd_chain(params, text, visual, acoustic, dy, *, beta_shift):
    """Kernel #26 on CUDA rows, its plain version on CPU ones."""
    fn = mag_bwd_cuda if _on(text) == "cuda" else mag_bwd_chain_plain
    return fn(params, text, visual, acoustic, dy, beta_shift=beta_shift)


def mag_backward(params, text, visual, acoustic, dy, *,
                 beta_shift: float = 1.0, input_grads=(True, True, True)):
    """The fused backward (``_mag_backward_pallas``): the chain (#26),
    then ``grads_from_chain``."""
    chain = mag_bwd_chain(params, _rows(text), _rows(visual),
                          _rows(acoustic), _rows(dy).to(text.dtype),
                          beta_shift=beta_shift)
    return grads_from_chain(params, text, visual, acoustic, dy, chain,
                            input_grads=input_grads)


def grads_from_chain(params, text, visual, acoustic, dy, chain, *,
                     input_grads=(True, True, True)):
    """The weight and input gradients from the chain's six [N, D] fp32
    tensors, as fp32 products and sums. Returns (dparams, dtext, dvisual,
    dacoustic), each in its primal's dtype and shape; an input gradient is
    None where ``input_grads`` (text, visual, acoustic) says it is not
    needed."""
    f32 = torch.float32
    t2, v2, a2 = _rows(text), _rows(visual), _rows(acoustic)
    dy2 = _rows(dy).to(text.dtype)
    dpv, dpa, ddv, dda, dt_partial, xhat = chain
    w = _weights(params)
    t32, v32, a32, dy32 = t2.to(f32), v2.to(f32), a2.to(f32), dy2.to(f32)
    dparams = {
        "w_hv_v": v32.T @ dpv, "w_hv_t": t32.T @ dpv,
        "b_hv": dpv.sum(dim=0),
        "w_ha_a": a32.T @ dpa, "w_ha_t": t32.T @ dpa,
        "b_ha": dpa.sum(dim=0),
        "w_v": v32.T @ ddv, "b_v": ddv.sum(dim=0),
        "w_a": a32.T @ dda, "b_a": dda.sum(dim=0),
        "ln_gamma": (dy32 * xhat).sum(dim=0),
        "ln_beta": dy32.sum(dim=0),
    }
    dparams = {k: g.to(params[k].dtype) for k, g in dparams.items()}
    dtext = dvis = dac = None
    if input_grads[0]:
        dtext = (dt_partial + dpv @ w["w_hv_t"].T
                 + dpa @ w["w_ha_t"].T).reshape(text.shape).to(text.dtype)
    if input_grads[1]:
        dvis = (dpv @ w["w_hv_v"].T + ddv @ w["w_v"].T).reshape(
            visual.shape).to(visual.dtype)
    if input_grads[2]:
        dac = (dpa @ w["w_ha_a"].T + dda @ w["w_a"].T).reshape(
            acoustic.shape).to(acoustic.dtype)
    return dparams, dtext, dvis, dac


class MagGateFused(torch.autograd.Function):
    """The gate with its backward kernel (JAX ``_fwd`` / ``_bwd``): the
    forward runs #25 and saves the residuals (params, text, visual,
    acoustic); the backward runs #26 and the plain products."""

    @staticmethod
    def forward(ctx, beta_shift: float, text, visual, acoustic, *params):
        ctx.beta_shift = beta_shift
        ctx.save_for_backward(text, visual, acoustic, *params)
        return mag_fwd(dict(zip(PARAM_NAMES, params)), text, visual,
                       acoustic, beta_shift=beta_shift)

    @staticmethod
    def backward(ctx, g):
        text, visual, acoustic, *params = ctx.saved_tensors
        params = dict(zip(PARAM_NAMES, params))
        dparams, dtext, dvis, dac = mag_backward(
            params, text, visual, acoustic, g.contiguous(),
            beta_shift=ctx.beta_shift, input_grads=ctx.needs_input_grad[1:4])
        return (None, dtext, dvis, dac,
                *(dparams[k] for k in PARAM_NAMES))


def mag_gate_fused(params: Mapping[str, torch.Tensor], text: torch.Tensor,
                   visual: torch.Tensor, acoustic: torch.Tensor, *,
                   beta_shift: float = 1.0) -> torch.Tensor:
    """Drop-in fused replacement for ``ops.mag.mag_gate`` (same semantics
    and param names): text [..., D], visual [..., Dv], acoustic [..., Da];
    returns [..., D] in ``text.dtype``. On CUDA tensors it launches #25
    (and #26 in the backward) or raises; on CPU tensors it runs their
    plain versions. Without a gradient to take it saves nothing."""
    _on(text)
    for x in (visual, acoustic):
        if x.device != text.device:
            raise ValueError(f"mag_gate_fused: inputs on {text.device} and "
                             f"{x.device}")
    params = {k: params[k].to(torch.float32).contiguous()
              for k in PARAM_NAMES}
    text, visual, acoustic = (x.contiguous() for x in (text, visual,
                                                       acoustic))
    tensors = (text, visual, acoustic, *params.values())
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in tensors)):
        return mag_fwd(params, text, visual, acoustic, beta_shift=beta_shift)
    return MagGateFused.apply(float(beta_shift), text, visual, acoustic,
                              *(params[k] for k in PARAM_NAMES))
