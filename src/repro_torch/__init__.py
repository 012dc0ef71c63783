"""PyTorch/CUDA port of the BitStopper serving system.

Mirrors the JAX package ``repro`` module for module (``core/``,
``kernels/``, ``models/``, ``configs/``, ``serving/``, ``checkpoint/``,
``runtime/``, ``launch/``).  It
imports ``torch`` and ``numpy`` only.  Entry points run on the CUDA card
unless the caller asks for the CPU; every TPU kernel on the ported path is
a CUDA kernel written for Hopper (``kernels/csrc/``), with a plain PyTorch
version beside it that runs for CPU tensors.
"""
