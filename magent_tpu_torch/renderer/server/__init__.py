from .base_server import BaseServer
from .sample_server import SampleServer
from .random_server import RandomServer
from .battle_server import BattleServer
from .arrange_server import ArrangeServer

__all__ = ["BaseServer", "SampleServer", "RandomServer", "BattleServer",
           "ArrangeServer"]
