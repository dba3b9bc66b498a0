"""PyTorch port of MAG-BERT and MAG-XLNet (serving, training and the CLI),
for NVIDIA Hopper GPUs.

The JAX package ``bert_multimodal_transformer_tpu`` is the reference; each
module here keeps the name of its counterpart there. This package imports
``torch`` and numpy only: never jax, flax or the JAX package.

The hand-written kernels (``csrc/*.cu``: packed and rel attention forward
and backward, the fused MAG gate) are built with nvcc at first use on a
CUDA tensor (``ops/kernels.py``); on CPU tensors their plain PyTorch
versions run.
"""
