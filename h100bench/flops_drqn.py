"""Model FLOPs of the DRQN that a fused train step needs (a multiply-add is
2), written as :mod:`h100bench.flops` counts the DQN's.

Counted from the configuration's shapes, whatever computes them: the
acting forward of every agent at every step of the window, the target
net's re-unroll of the window, and the online net's backward through time
over the frames whose Q values enter the loss (all but the last).  The
backward needs each layer's weight gradient and every input gradient but
those of data: the two trunk layers' inputs (views, features) and, at the
window's first frame, the state it started from.  The checkpoint's
recompute, biases, activations, the gates' elementwise work and the
dueling mean are left out."""

from __future__ import annotations


def drqn_forward(view_space, feature_size, n_action, net):
    """Per agent step, by layer: the trunk's two dense layers, the GRU's
    three input and three state projections, the heads."""
    vh, vw, C = view_space
    d, H = net["dense"], net["state_size"]
    layers = {
        "dense_view": 2 * vh * vw * C * d,
        "dense_emb": 2 * feature_size * d,
        "gru_in": 3 * 2 * (2 * d) * H,
        "gru_state": 3 * 2 * H * H,
        "heads": 2 * H * (1 + n_action if net["dueling"] else n_action),
    }
    layers["total"] = sum(layers.values())
    return layers


def drqn_train_step(per, n_agents, window):
    """FLOPs of one train step over ``n_agents`` agents (worlds times the
    groups' caps) and a window of ``window`` frames, from
    :func:`drqn_forward`'s per-step counts."""
    f = per["total"]
    forward = n_agents * window * f  # the acting unroll
    target = n_agents * window * f  # the target net's re-unroll
    backward = n_agents * ((window - 1) * (2 * f - per["dense_view"]
                                           - per["dense_emb"])
                           - per["gru_state"])
    return forward + target + backward
