"""PyTorch port of the MAG-BERT serving forward, for NVIDIA Hopper GPUs.

The JAX package ``bert_multimodal_transformer_tpu`` is the reference; each
module here keeps the name of its counterpart there. This package imports
``torch`` and numpy only: never jax, flax or the JAX package.

The one hand-written kernel of the serving path is the packed attention
forward (``ops/fused_attention.py`` → ``csrc/attn_fwd_packed.cu``), built
with nvcc at first use on a CUDA tensor.
"""
