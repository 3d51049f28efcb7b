"""The ``dqn_train_dp`` kind on the CPU: the tiny ``battle_dqn.train_dp4``
cell on two ``gloo`` ranks (this process and one worker) is correct
against the reference on the global batch, and reads ``correct`` false
with the gradient exchange left out on every rank."""

import io
import types
from pathlib import Path

import torch

from h100bench import ranks, run

from .tiny import entries, last_line

CELL = "battle_dqn.train_dp4"
HERE = Path(__file__).resolve().parent


def run_two_ranks(seed=2**31 + 9):
    wl, cfg, traffic, per_layer, e2e = entries(CELL)
    traffic.update(dp=2, rollout=3, train_minibatch=64)
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=0.5,
                                 trace=0,
                                 entries=(wl, cfg, traffic, per_layer, e2e))
    out, err = io.StringIO(), io.StringIO()
    result = run.run_cell(args, device=torch.device("cpu"), out=out, err=err)
    return result, out.getvalue(), err.getvalue()


def test_two_gloo_ranks_train_as_one_card_on_the_global_batch():
    result, out, err = run_two_ranks()
    line = last_line(out)
    assert line["correct"] is True, err
    assert set(line["metrics"]) == {"train_agent_steps_per_s", "setup_s"}
    assert "5 checked train steps" in err  # set-up's 3, the call after's 2


def test_the_exchange_left_out_is_not_correct(monkeypatch):
    from magent_tpu_torch.parallel import train

    monkeypatch.setattr(train, "all_reduce_flat",
                        lambda tensors, mesh, axis: list(tensors))
    cmd = ranks.worker_cmd

    def planted(*a):
        c = cmd(*a)
        return [c[0], str(HERE / "_dp_no_exchange_rank.py")] + c[3:]
    monkeypatch.setattr(ranks, "worker_cmd", planted)
    result, out, err = run_two_ranks()
    assert last_line(out)["correct"] is False
    assert "FAILED" in err
