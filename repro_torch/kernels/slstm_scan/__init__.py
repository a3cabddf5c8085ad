"""sLSTM recurrent scan with exponential gating: CUDA kernel, wrapper, plain
version."""
from .ops import slstm_scan
from .ref import slstm_scan_ref

__all__ = ["slstm_scan", "slstm_scan_ref"]
