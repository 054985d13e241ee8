"""PyTorch/CUDA port of the Roaring bitmap query stack.

Mirrors the reference package ``repro`` subpackage by subpackage and
produces the same bytes; imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``repro``. Entry points run on the card unless the caller passes
``device="cpu"``; the hand-written CUDA kernels live in
``repro_torch.kernels.roaring.csrc`` and build at first use.
"""
