"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``kernels/ref.py`` holds the oracles the tests compare against)."""
