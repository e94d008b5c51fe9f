"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the wrappers (``ops``) that pick between them by device."""
