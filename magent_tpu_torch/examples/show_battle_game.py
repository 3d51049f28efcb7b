"""Play the interactive battle game against trained models (port of
``examples/show_battle_game.py``; parity with reference
examples/show_battle_game.py).

It loads the trusty-battle-game-l/r checkpoints from ``save_model`` or,
failing that, the ones bundled in ``data/models``.  From the repository
root::

    python -m magent_tpu_torch.examples.show_battle_game [--device cpu]

The game runs on the GPU unless ``--device`` names another device."""

import argparse

from magent_tpu_torch.renderer import PyGameRenderer
from magent_tpu_torch.renderer.server import BattleServer


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device of the game (default: the GPU)")
    args = parser.parse_args(argv)
    PyGameRenderer().start(BattleServer(device=args.device))


if __name__ == "__main__":
    main()
