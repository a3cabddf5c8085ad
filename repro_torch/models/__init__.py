"""The dense GQA decoder in PyTorch: params as nested dicts of tensors whose
keys match the JAX param tree leaf for leaf (stacked ``dec0/p0/...`` leaves
keep their leading layers axis)."""
