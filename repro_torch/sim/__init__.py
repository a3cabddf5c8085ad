from .events import EventQueue
from .traces import TraceConfig, generate_trace, generate_type_trace, \
    potential_counts
from .experiment import MIXED_SCENARIOS, ScenarioConfig, run_scenario, \
    SCENARIOS
from .openended import FirehoseConfig, firehose
from .churn import ChurnConfig, ChurnEvent, ChurnInjector, churn_schedule
from .chaos import CHAOS_SCENARIOS, ChaosConfig, chaos_gate, run_chaos
from .scenarios import (
    LargeNConfig,
    generate_arrivals,
    run_large_n,
    LARGE_N_TIERS,
    sweep_devices,
    sweep_mix,
)

__all__ = [
    "EventQueue",
    "TraceConfig",
    "generate_trace",
    "generate_type_trace",
    "potential_counts",
    "MIXED_SCENARIOS",
    "ScenarioConfig",
    "run_scenario",
    "SCENARIOS",
    "FirehoseConfig",
    "firehose",
    "ChurnConfig",
    "ChurnEvent",
    "ChurnInjector",
    "churn_schedule",
    "CHAOS_SCENARIOS",
    "ChaosConfig",
    "chaos_gate",
    "run_chaos",
    "LargeNConfig",
    "generate_arrivals",
    "run_large_n",
    "LARGE_N_TIERS",
    "sweep_devices",
    "sweep_mix",
]
