"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel package holds ``csrc/*.cu`` (the CUDA source), ``ref.py`` (the
plain version) and ``ops.py`` (the wrapper).  A wrapper runs the plain
version for CPU tensors, launches the kernel for CUDA tensors, and counts
its launches in the ``launches`` attribute of the wrapper function.
"""
