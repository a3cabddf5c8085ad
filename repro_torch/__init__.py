"""PyTorch/CUDA port of the preemption-aware serving system.

Mirrors the layout of the JAX package (``core``, ``sim``, ``models``,
``configs``, ``kernels``, ``training``, ``serving``) and imports none of it.
The scheduler plane (``core``, ``sim/events.py``) and ``models/config.py``
are verbatim copies; everything that computes is written against ``torch``.

Every entry point takes ``device=`` and defaults to ``"cuda"``: without a
card it raises unless the caller asks for ``device="cpu"`` explicitly (see
:func:`repro_torch.device.resolve_device`).  Attention goes through
hand-written Hopper kernels on CUDA tensors and through their plain PyTorch
versions on CPU tensors.
"""
