"""PyTorch + CUDA port of trainner_redux_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX one, with the same layout (archs, data,
metrics, models, ops, utils) and hand-written CUDA kernels under `csrc/`.
It imports torch and nothing of JAX or of the JAX package.
"""
