"""sLSTM recurrent scan with exponential gating: CUDA kernels (forward and
backward), wrappers, the model-layout adapter, plain versions."""
from .ops import SLSTMScanFn, slstm_hidden_states, slstm_scan, \
    slstm_scan_bwd, slstm_scan_saving
from .ref import slstm_scan_bwd_ref, slstm_scan_ref, slstm_scan_saving_ref

__all__ = ["SLSTMScanFn", "slstm_hidden_states", "slstm_scan",
           "slstm_scan_bwd", "slstm_scan_bwd_ref", "slstm_scan_ref",
           "slstm_scan_saving", "slstm_scan_saving_ref"]
