"""Preemption-aware serving over real PyTorch compute."""
