"""Serving layer: the one-shot jax engine and the streaming engine.

Exports resolve lazily (PEP 562) so jax-free consumers — the streaming
engine, the open-ended trace generators, ``benchmarks/soak.py`` — can
``import repro.serving.stream`` without paying (or requiring) the jax
import that ``engine``/``cost_model`` pull in.
"""
from importlib import import_module

_LAZY = {
    "CostModel": ".cost_model",
    "PhaseCost": ".cost_model",
    "analytic_cost_model": ".cost_model",
    "measure_cost_model": ".cost_model",
    "PreemptiveServingEngine": ".engine",
    "ServeRequest": ".engine",
    "engine_network_config": ".engine",
    "StreamingEngine": ".stream",
    "StreamRequest": ".stream",
    "StreamArrival": ".stream",
    "Backpressure": ".stream",
    "AdmissionQueue": ".stream",
    "validate_submission": ".stream",
    "register_shed_policy": ".stream",
    "create_shed_policy": ".stream",
    "registered_shed_policies": ".stream",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(import_module(module, __name__), name)


def __dir__():
    return __all__
