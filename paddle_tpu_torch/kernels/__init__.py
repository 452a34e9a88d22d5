"""Hand-written CUDA kernels for Hopper and their plain PyTorch
versions. Sources live in `csrc/`; `_build` compiles them at first use."""
