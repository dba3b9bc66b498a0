"""The port's kernels: each CUDA wrapper (a ``*_cuda`` function of
``fused_attention`` or ``mag_fused``) counts its launches in its own
``.launches``."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process, by kernel
    name (the wrapper's without ``_cuda``)."""
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention,
        mag_fused,
    )

    return {name[:-len("_cuda")]: fn.launches
            for mod in (fused_attention, mag_fused)
            for name, fn in vars(mod).items()
            if name.endswith("_cuda") and hasattr(fn, "launches")}
