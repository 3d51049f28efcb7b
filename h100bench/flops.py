"""Model FLOPs of the DQN that a train step needs (a multiply-add is 2).

Counted from the configuration's shapes, whatever computes them: the
acting forward of every agent at every rollout step, and per minibatch
row the learner's online forward and backward at the taken transition
and the online and target forwards at the next one.  The backward needs
each layer's weight gradient and the input gradient of every layer but
the first of each stream (their inputs are data).  Biases, activations
and the dueling mean are left out."""

from __future__ import annotations


def dqn_forward(view_space, feature_size, n_action, net):
    vh, vw, C = view_space
    ch, k, d = net["conv_channels"], net["conv_kernel"], net["dense"]
    h1, w1 = vh - (k - 1), vw - (k - 1)
    h2, w2 = h1 - (k - 1), w1 - (k - 1)
    layers = {
        "conv1": 2 * h1 * w1 * ch * k * k * C,
        "conv2": 2 * h2 * w2 * ch * k * k * ch,
        "dense_view": 2 * h2 * w2 * ch * d,
        "dense_emb": 2 * feature_size * d,
        "heads": 2 * 2 * d * (1 + n_action),
    }
    layers["total"] = sum(layers.values())
    return layers


def dqn_learn(per, minibatch):
    """FLOPs of one learner step on ``minibatch`` rows, from
    :func:`dqn_forward`'s per-row counts."""
    f = per["total"]
    backward = 2 * f - per["conv1"] - per["dense_emb"]
    return minibatch * (f + backward + 2 * f)
