"""Replay rendering: frame dumps in the reference text format
(config.json + video_<k>.txt), consumed by the C++ WebSocket replay server
and the HTML/Canvas frontend (port of ``magent_tpu/render``)."""

from .generator import RenderGenerator, SnakeRenderGenerator, attack_events

__all__ = ["RenderGenerator", "SnakeRenderGenerator", "attack_events"]
