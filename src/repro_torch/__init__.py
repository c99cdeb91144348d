"""PyTorch/CUDA port of the ``repro`` package (Semaphores Augmented with a
Waiting Array as the admission core of a serving engine).

It mirrors ``repro``'s layout and names, imports ``torch`` and numpy and
never ``jax`` or ``repro``.  Hand-written CUDA kernels for Hopper live in
``csrc/`` and are built at first use (`kernels.build`); every kernel has a
plain PyTorch version beside it, which the wrappers take for CPU tensors.
"""
