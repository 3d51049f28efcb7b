"""How close two runs of a fused DQN train step must be (JAX-free: the card
tests import it too).

Adam's first steps move a parameter by about ``lr * sign(g)`` wherever the
gradient ``g`` lies well above eps, so two runs whose gradients differ by
summation order move a parameter the same way, unless its gradient is 0
within that difference: then its sign may differ, and the parameter moves
by up to ``2 * lr`` per step the other way.  So the first and second
moments (the gradients scaled) are held to ``moment_rtol`` of each
tensor's largest magnitude; the parameters to ``param_atol`` per step
wherever the reference's first moment is larger than that (the gradient's
sign is settled), and to ``2 * lr`` per step more everywhere else.  A
ReLU whose input lies within rounding of 0 may open in one run and not in
the other and pass a whole sample's gradient; runs on one kind of device
(the CPU) rarely meet one, the card against the CPU did (its
``moment_rtol`` says by how much)."""

import numpy as np

from magent_tpu_torch.builtin.torch_model import (params_to_flax,
                                                  tensors_to_flax)


def step_flat(nets, opt_states):
    """Per group: (parameters, (mu, nu)) of the port's nets and ``ClipAdam``
    states as flat flax dicts."""
    out = []
    for net, st in zip(nets, opt_states):
        names = [n for n, _ in net.named_parameters()]
        out.append((params_to_flax(net), tuple(
            tensors_to_flax(dict(zip(names, getattr(st, m))))
            for m in ("mu", "nu"))))
    return out


def assert_adam_steps_close(got, want, got_moments, want_moments, *, lr,
                            steps=1, moment_rtol, param_atol, tag=""):
    """``got``/``want``: flat dicts (name -> float32 array) of parameters
    after ``steps`` steps; ``*_moments``: ``(mu, nu)`` flat dicts of the same
    names."""
    assert set(got) == set(want), tag
    for moment, g_m, w_m in zip(("mu", "nu"), got_moments, want_moments):
        for name in want:
            scale = float(np.abs(w_m[name]).max())
            np.testing.assert_allclose(
                g_m[name], w_m[name], rtol=0, atol=moment_rtol * scale,
                err_msg="%s %s %s" % (tag, moment, name))
    mu = want_moments[0]
    for name in want:
        diff = np.abs(got[name] - want[name])
        settled = np.abs(mu[name]) > moment_rtol * np.abs(mu[name]).max()
        assert diff[settled].max(initial=0.0) <= param_atol * steps, (
            tag, name, float(diff[settled].max(initial=0.0)))
        assert diff.max() <= (2 * lr + param_atol) * steps, (
            tag, name, float(diff.max()))


def flatten_tree(tree, prefix=""):
    """A nested dict of arrays (a flax parameter tree, an optax moment) ->
    the flat ``{"a/b/kernel": ndarray}`` of a checkpoint."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flatten_tree(v, prefix + k + "/"))
    return out


def assert_optax_steps_close(nets, opt_states, jparams, jopts, *, lr,
                             steps=1, moment_rtol, param_atol, tag=""):
    """The port's nets and ``ClipAdam`` states against optax's parameters
    and ``chain(clip_by_global_norm, adam)`` states (``(clip state, (adam
    state, ...))``), per group, by :func:`assert_adam_steps_close`'s
    rule."""
    for g, ((params, moments), jp, jst) in enumerate(zip(
            step_flat(nets, opt_states), jparams, jopts)):
        adam = jst[1][0]
        assert opt_states[g].count == int(adam.count), tag
        assert_adam_steps_close(
            params, flatten_tree(jp), moments,
            (flatten_tree(adam.mu), flatten_tree(adam.nu)), lr=lr,
            steps=steps, moment_rtol=moment_rtol, param_atol=param_atol,
            tag="%s group %d" % (tag, g))
