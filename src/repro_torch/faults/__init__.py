"""Deterministic fault injection: declarative schedules compiled to dense
tables that the evaluator's loop reads (the port of ``repro.faults``). See
``schedule.py``."""
from .schedule import (   # noqa: F401
    CrashWindow,
    FaultSchedule,
    FaultTables,
    HeartbeatLoss,
    LinkFlap,
    Straggler,
    TransientErrors,
    backoff_jitter_u,
    heartbeat_lost,
    link_slowdown_np,
    link_slowdown_torch,
    mix32_torch,
    node_available_np,
    node_available_torch,
    node_slowdown_np,
    node_slowdown_torch,
    torch_tables,
    transient_delay_np,
    transient_delay_torch,
    transient_hit_np,
)
