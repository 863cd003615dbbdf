"""Hand-written Hopper kernels of the block path, each beside its plain
PyTorch version: the wrapper runs the plain version for a tensor on the CPU
and launches the kernel (or raises) for a tensor on the card."""
