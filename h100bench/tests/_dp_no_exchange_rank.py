"""A worker rank of ``h100bench.ranks`` with the trainer's gradient
exchange left out (the fault that ``test_dqn_train_dp_kind.py`` plants in
every rank)."""

import sys

from magent_tpu_torch.parallel import train

from h100bench import ranks

train.all_reduce_flat = lambda tensors, mesh, axis: list(tensors)

if __name__ == "__main__":
    sys.exit(ranks.main(sys.argv[1:]))
