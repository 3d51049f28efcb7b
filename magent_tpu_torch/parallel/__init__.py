"""Lockstep vectorized envs of the port, and the fused DQN trainers."""

from .optim import AdamState, ClipAdam
from .train import (make_dqn_remat_train_loop, make_dqn_train_loop,
                    make_dqn_train_step, make_dqn_train_step_remat,
                    make_eval_q, sample_eval_set)
from .vec_env import VecGridWorld, resolve_device

__all__ = ["AdamState", "ClipAdam", "VecGridWorld", "make_dqn_remat_train_loop",
           "make_dqn_train_loop", "make_dqn_train_step",
           "make_dqn_train_step_remat", "make_eval_q", "resolve_device",
           "sample_eval_set"]
