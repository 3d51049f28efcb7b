"""magent_tpu_torch: the PyTorch/CUDA port of magent_tpu.

The JAX package ``magent_tpu`` is the reference; this package runs the same
many-agent gridworld on an NVIDIA GPU with PyTorch and hand-written CUDA
kernels (``csrc/``), and imports nothing of JAX or of ``magent_tpu``.

Ported so far: the stateful ``GridWorld`` API on the engine's grid path
(any walls, multi-cell bodies, food, turn mode and absorb) and in
``engine_mode="sequential"`` (the reference C++ engine's order, stepped on
the host by ``core.seq_engine``, observed on the device), the lockstep
vectorized loop (``parallel.VecGridWorld``) on the gridless path,
1x1 bodies and pursuit's multi-cell rect bodies, with optional interior
walls (on the grid path past the pair kernels' caps and for food, turn
mode and absorb) — device reset (random facings in turn mode), NORTH-only
and, in turn mode, rotating observations, both random-action samplers —
and ``discrete_snake.DiscreteSnake`` (also ``magent_tpu_torch.DiscreteSnake``,
as in the JAX package); the fused DQN, A2C (with CommNet) and DRQN trainers
(``parallel.train``) and their nets (``builtin.torch_model``); the model
layer: ``BaseModel``, ``ProcessingModel`` and ``SubprocessModel``
(``model``), ``utility``, the rule bots (``builtin.rule_model``) and the
per-agent ``DeepQNetwork``, ``AdvantageActorCritic`` and
``DeepRecurrentQNetwork`` (``builtin.torch_model``, also under the
reference's name ``builtin.tf_model``), whose checkpoints are the JAX
package's files; and rendering: replay dumps (``render``), the PyGame
client and its game servers (``renderer``, ``renderer.server``) and the
live games' entry points (``examples.show_battle_game``,
``examples.show_arrange``); the examples and scale scripts
(``examples``: the ``train_*`` examples over ``examples.rollout``,
``api_demo``, ``test_1m``, ``test_mega``, ``test_fps`` and the harnesses)
and the second NN backend they select with ``--backend torch``
(``builtin.th_model``, also under the reference's name
``builtin.mx_model``); and sharding: the ``("dp", "tp")`` mesh over
``torch.distributed`` (``parallel.sharding``), with its multi-process
launcher and scaling harness (``examples.launch_multihost``,
``examples.test_scaling``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
except the sequential snake (``DiscreteSnake(..., engine_mode=
"sequential")``, ``core.seq_snake``): host NumPy only, like the JAX
package's, it takes no device.
"""

from . import builtin, gridworld, utility
from .discrete_snake import DiscreteSnake
from .env import GridWorld
from .model import BaseModel, ProcessingModel, SubprocessModel

round = utility.rec_round

__all__ = ["BaseModel", "DiscreteSnake", "GridWorld", "ProcessingModel",
           "SubprocessModel", "gridworld", "round", "utility"]
