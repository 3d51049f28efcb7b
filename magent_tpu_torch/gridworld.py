"""``magent.gridworld``-compatible module: env + config DSL in one namespace
(reference: python/magent/gridworld.py; as ``magent_tpu/gridworld.py``)."""

from .config import AgentSymbol, Config, CircleRange, Event, EventNode, SectorRange
from .env import GridWorld, Handle

__all__ = [
    "AgentSymbol", "Config", "CircleRange", "Event", "EventNode",
    "SectorRange", "GridWorld", "Handle",
]
