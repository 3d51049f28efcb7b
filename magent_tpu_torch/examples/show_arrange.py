"""Watch agents arrange themselves into a message (port of
``examples/show_arrange.py``; parity with reference examples/show_arrange.py).

From the repository root::

    python -m magent_tpu_torch.examples.show_arrange [MESSAGE ...] [--device cpu]

The game runs on the GPU unless ``--device`` names another device."""

import argparse

from magent_tpu_torch.renderer import PyGameRenderer
from magent_tpu_torch.renderer.server import ArrangeServer


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("messages", nargs="*", default=["HELLO"],
                        help="the lines to spell (default: HELLO)")
    parser.add_argument("--device", default=None,
                        help="torch device of the game (default: the GPU)")
    args = parser.parse_args(argv)
    PyGameRenderer().start(ArrangeServer(messages=args.messages,
                                         device=args.device))


if __name__ == "__main__":
    main()
