"""The decoder models in PyTorch (dense GQA, xLSTM): params as nested dicts of tensors whose
keys match the JAX param tree leaf for leaf (stacked ``dec0/p0/...`` leaves
keep their leading layers axis)."""
