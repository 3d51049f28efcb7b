"""Shared set-up of the tests that hold the port's driving scripts
(``magent_tpu_torch/tools``, ``/examples``) against the JAX scripts: each
JAX script loaded from its file with ``importlib`` (never edited), its
``jax`` module swapped for one whose ``jit`` records every call, and the
JAX nets' flax parameters carried into the port's nets."""

import argparse
import importlib.util
import os
import sys
import types

import jax

from magent_tpu_torch.builtin.torch_model import params_from_flax

from _torch_train_checks import flatten_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(relpath, name=None):
    """The JAX script at ``relpath`` (from the repository root) as a fresh
    module.  The scripts put their directories on ``sys.path`` and set
    ``JAX_COMPILATION_CACHE_DIR``; both are restored after the load."""
    path = os.path.join(REPO, relpath)
    env, syspath = dict(os.environ), list(sys.path)
    spec = importlib.util.spec_from_file_location(
        name or "jax_script_" + os.path.splitext(os.path.basename(path))[0],
        path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = syspath
    return mod


class _Parsed(Exception):
    pass


def jax_cli_defaults(jm, monkeypatch, argv=()):
    """The defaults a JAX script's ``main`` parses from ``argv`` (the
    scripts build their parsers inside ``main``): its ``argparse`` is
    swapped for one whose parser records them and stops ``main``."""
    seen = {}

    class Parser(argparse.ArgumentParser):
        def parse_args(self, args=None, namespace=None):
            seen.update(vars(super().parse_args(list(argv))))
            raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(jm, "argparse", types.SimpleNamespace(
            ArgumentParser=Parser))
        try:
            jm.main()
        except _Parsed:
            return seen
    raise AssertionError("%s's main parsed no arguments" % jm.__name__)


class RecordingJax:
    """A stand-in for a JAX script's ``jax`` module: every attribute is
    ``jax``'s, but a function jitted through it records each call as
    ``(function, args, outputs)`` in ``calls``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def call(*args):
            out = jitted(*args)
            self.calls.append((fn, args, out))
            return out

        return call

    def outputs_of(self, fn_name):
        return [out for fn, _, out in self.calls
                if getattr(fn, "__name__", "") == fn_name]


def port_nets_from_flax(template, params):
    """``template``'s nets (one per group) loaded with the flax parameter
    trees ``params`` -> new nets on the CPU."""
    nets = []
    for net, p in zip(template, params):
        net.load_state_dict(params_from_flax(flatten_tree(p)))
        nets.append(net)
    return tuple(nets)

