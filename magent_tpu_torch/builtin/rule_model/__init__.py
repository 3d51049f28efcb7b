"""The rule bots (port of ``magent_tpu/builtin/rule_model``): NumPy over
the views, the same NumPy calls in the same order as the JAX package's."""

from .random import RandomActor
from .rush import RushPredator
from .runaway import RunawayPrey
from .rushgather import RushGatherer

__all__ = ["RandomActor", "RushPredator", "RunawayPrey", "RushGatherer"]
