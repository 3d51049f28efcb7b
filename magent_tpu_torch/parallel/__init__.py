"""Lockstep vectorized envs of the port, the fused DQN, A2C and DRQN
trainers, and the ``("dp", "tp")`` mesh they shard over."""

from .optim import AdamState, ClipAdam
from .sharding import (Mesh, Sharding, device_put, gather, make_mesh,
                       param_sharding, replicated, state_sharding)
from .train import (init_drqn_hiddens, make_a2c_train_loop,
                    make_a2c_train_step, make_dqn_remat_train_loop,
                    make_dqn_train_loop, make_dqn_train_step,
                    make_dqn_train_step_remat, make_drqn_train_loop,
                    make_drqn_train_step, make_eval_q, sample_eval_set)
from .vec_env import VecGridWorld, resolve_device

__all__ = ["AdamState", "ClipAdam", "Mesh", "Sharding", "VecGridWorld",
           "device_put", "gather", "init_drqn_hiddens",
           "make_a2c_train_loop", "make_a2c_train_step",
           "make_dqn_remat_train_loop", "make_dqn_train_loop",
           "make_dqn_train_step", "make_dqn_train_step_remat",
           "make_drqn_train_loop", "make_drqn_train_step", "make_eval_q",
           "make_mesh", "param_sharding", "replicated", "resolve_device",
           "sample_eval_set", "state_sharding"]
