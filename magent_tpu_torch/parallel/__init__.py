"""Lockstep vectorized envs of the port, and the fused DQN, A2C and DRQN
trainers."""

from .optim import AdamState, ClipAdam
from .train import (init_drqn_hiddens, make_a2c_train_loop,
                    make_a2c_train_step, make_dqn_remat_train_loop,
                    make_dqn_train_loop, make_dqn_train_step,
                    make_dqn_train_step_remat, make_drqn_train_loop,
                    make_drqn_train_step, make_eval_q, sample_eval_set)
from .vec_env import VecGridWorld, resolve_device

__all__ = ["AdamState", "ClipAdam", "VecGridWorld", "init_drqn_hiddens",
           "make_a2c_train_loop", "make_a2c_train_step",
           "make_dqn_remat_train_loop", "make_dqn_train_loop",
           "make_dqn_train_step", "make_dqn_train_step_remat",
           "make_drqn_train_loop", "make_drqn_train_step", "make_eval_q",
           "resolve_device", "sample_eval_set"]
