"""Hand-written Hopper kernels and their plain PyTorch versions."""

from repro_torch.kernels.ops import attention  # noqa: F401
