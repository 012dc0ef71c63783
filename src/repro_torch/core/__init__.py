"""BitStopper core algorithms in PyTorch: quantization, margins, LATS, BESF."""
