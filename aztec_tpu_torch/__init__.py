"""PyTorch + CUDA port of aztec_tpu (PLONK proving on an NVIDIA H100).

Same subpackages and module names as ``aztec_tpu``; tensors keep the
reference's (16, n) 16-bit-limb Montgomery planes (stored as int32).  Entry
points take an explicit ``device`` (default ``"cuda"``); nothing here
imports JAX or the ``aztec_tpu`` package.
"""
