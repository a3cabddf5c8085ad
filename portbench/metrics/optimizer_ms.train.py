"""Device milliseconds of the AdamW update a step in the traced window: the
mean of the last ``steps`` CUDA event pairs around ``adamw_update`` that the
program's ``train.optimizer`` span records (``repro_torch.tracing``)."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    ms = [m for _, m in tracing.device_spans("train.optimizer")]
    ms = ms[-ctx["steps"]:] if ctx["steps"] else []
    if not ms:
        return None
    return sum(ms) / len(ms)
