"""Rematerialized encoder layers (the JAX package's ``nn.remat`` over
``BertLayer`` and ``XLNetLayer``): a layer's activations are dropped after
its forward and recomputed in the backward, trading one more forward per
layer for the memory of its intermediates.

``remat_call`` runs one layer under ``torch.utils.checkpoint`` with
``use_reentrant=False``: the reentrant form runs the first forward under
``no_grad``, so a kernel entry that chooses by whether a gradient is taken
(``fused_attention_packed`` saves its probs only then) would run another
kernel in the first pass than in the recompute.

Policies (``remat_policy``): "full" recomputes the whole layer; "dots"
saves the outputs of the matrix products (``aten.mm``, ``aten.addmm``,
``aten.bmm``) and recomputes the rest, JAX's ``checkpoint_dots``. The
attention and MAG kernels' autograd functions are not products: they are
recomputed, as the Pallas calls are under JAX's policy.

The dropout draws. The port draws from the explicit streams of
``ops/dropout.py``, not from the global generators that ``checkpoint``'s
``preserve_rng_state`` restores: under rbg ``DropoutRngs``, whose host
generator gives each layer's kernel seed and whose device generator the
hidden and einsum masks; under threefry ``ThreefryRngs``, whose keys are
values derived from the Flax scope counters. ``remat_call`` records the
stream's state (both generators' states, or the counters) on entry to the
layer, sets it back for the recompute, and restores the outer state after
it, so the recompute draws the seeds and masks of the first pass and a
rematerialized step equals the plain step bit for bit.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

REMAT_POLICIES = ("full", "dots")


def check_remat_policy(policy: str) -> None:
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"remat_policy must be 'full' or 'dots', got {policy!r}")


def check_remat_outputs(remat: bool, output_attentions: bool) -> None:
    if remat and output_attentions:
        raise ValueError(
            "output_attentions is incompatible with remat (the "
            "rematerialized stack discards per-layer probs)")


def _dots_contexts():
    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.addmm.default, aten.bmm.default])


def remat_call(layer, rngs, policy: str, /, *args, **kwargs):
    """``layer(*args, **kwargs)`` with its activations rematerialized
    under ``policy``, the recompute replaying ``rngs``' draws (module
    docstring). Without a gradient to take there is nothing to save, and
    the layer runs as it is."""
    if not torch.is_grad_enabled():
        return layer(*args, **kwargs)
    entry = None if rngs is None else rngs.get_state()
    calls = 0

    def run(*a, **kw):
        nonlocal calls
        calls += 1
        if calls == 1 or entry is None:
            return layer(*a, **kw)
        outer = rngs.get_state()
        rngs.set_state(entry)
        try:
            return layer(*a, **kw)
        finally:
            # the recompute may stop early (checkpoint's early stop raises
            # out of it); the outer draws continue where they were
            rngs.set_state(outer)

    return checkpoint(
        run, *args, use_reentrant=False,
        # the global generators are not drawn from: the replay above is
        # the one that matters
        preserve_rng_state=False,
        context_fn=(_dots_contexts if policy == "dots"
                    else noop_context_fn), **kwargs)

