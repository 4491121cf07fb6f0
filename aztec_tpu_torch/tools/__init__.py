"""Entry points that measure the card: ports of the TPU tools of ``tools/``.

``vpu_microbench`` (chains of one 32-bit operation: the card's issue rates)
and ``kernel_dissect`` (the stages of a Montgomery product), each a CUDA
kernel of ``csrc/microbench.cu`` with its plain PyTorch version beside it;
``timing`` reads kernel times on the card's own clock.  Run on the card:

    python -m aztec_tpu_torch.tools.vpu_microbench
    python -m aztec_tpu_torch.tools.kernel_dissect
"""
