"""Train the models used by the interactive battle game (port of
``examples/train_battle_game.py``; parity with reference
examples/train_battle_game.py): the battle training loop of
:mod:`.train_battle` under the names ``trusty-battle-game-l/r``, the
checkpoints that ``show_battle_game`` and ``BattleServer`` load.  From the
repository root::

    python -m magent_tpu_torch.examples.train_battle_game --train
"""

import sys

from magent_tpu_torch.examples import train_battle


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--name" not in argv:
        argv += ["--name", "trusty-battle-game"]
    train_battle.main(argv)


if __name__ == "__main__":
    main()
