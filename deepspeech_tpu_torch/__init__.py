"""PyTorch/CUDA port of deepspeech_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's module names (``audio``, ``ops``,
``models``, ``decoders``, ``cli``, ...) so that every module has an obvious
counterpart. It imports torch, numpy and scipy only: nothing of JAX and
nothing of ``deepspeech_tpu``.

The TPU Pallas kernels on the inference path are hand-written CUDA C++
kernels under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(``ops/cuda/build.py``). Each kernel's wrapper runs a plain PyTorch twin for
CPU tensors and launches the kernel (or raises) for CUDA tensors.
"""

from deepspeech_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
