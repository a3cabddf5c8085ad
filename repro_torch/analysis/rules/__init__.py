"""Shipped rule families.

Each module contributes one family; ``repro_torch.analysis.engine.
default_rules`` assembles the stable shipped order.
"""
from .determinism import SetIterRule, UnseededRngRule, WallClockRule
from .kernel_rules import TorchImportRule
from .mirror_sync import DirtyNotifyRule, MirrorWriteRule
from .terminal_state import SETTLE_HELPERS, TerminalStateRule

__all__ = [
    "MirrorWriteRule",
    "DirtyNotifyRule",
    "TerminalStateRule",
    "SETTLE_HELPERS",
    "WallClockRule",
    "UnseededRngRule",
    "SetIterRule",
    "TorchImportRule",
]
