"""The port's ``tools.profile_drqn`` and ``tools.profile_banded`` against
``scripts/profile_drqn.py`` and ``scripts/profile_banded.py`` (loaded with
``importlib``, ``jax`` swapped for one that records each jitted call) on
the CPU at a tiny size: each variant's warm-up sink against the JAX
variant's, profile_drqn's 13 (the fixed trajectory's TD loss, its
gradients' flax-layout sinks, the composed and rematerialized steps
included) and profile_banded's, its opt-in ``plain`` against JAX's
``xla``.  Integer sinks (the rollout's actions, SORT's tables) and sums
of rewards are exact; sums over Q values, losses, gradients and windows
(hundreds of f32 terms summed in another order than XLA's) within rtol
1e-5, the trainers' tolerance (PERF.md §2).  profile_drqn runs from the
JAX script's flax init, carried across with ``params_from_flax``."""

import sys

import pytest
import torch

from magent_tpu_torch.builtin.torch_model import DRQNNet
from magent_tpu_torch.tools import profile_banded, profile_drqn

from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_script_cases import (RecordingJax, jax_cli_defaults, jax_script,
                                 port_nets_from_flax)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DRQN_ARGV = ["--n_per_group", "10", "--map_size", "20", "--n_envs", "2",
             "--rollout_len", "3", "--calls", "1", "--inner", "2",
             "--dtype", "f32", "--state_size", "16"]
# the order of the JAX script's variants (a warm-up and one timed call
# each), the port's VARIANTS
JAX_DRQN_ORDER = ("env_only", "rollout", "rollout_st", "rollout+unr",
                  "loss_fwd", "grad", "grad_remat", "train_noopt",
                  "act_gradfix", "rand_grad", "full", "full_remat_dots",
                  "full_remat_all")
EXACT = ("env_only", "rollout", "sort")


def test_cli_defaults_match_the_jax_scripts(monkeypatch):
    for name, mod in (("profile_drqn", profile_drqn),
                      ("profile_banded", profile_banded)):
        seen = jax_cli_defaults(jax_script("scripts/%s.py" % name),
                                monkeypatch)
        got = vars(mod.cli().parse_args([]))
        assert got.pop("device") is None
        assert got == seen, name


def _close(name, got, want):
    if name in EXACT:
        assert got == want, name
    else:
        assert got == pytest.approx(want, rel=1e-5), name


def test_profile_drqn_sinks_match_jax(monkeypatch):
    jm = jax_script("scripts/profile_drqn.py")
    rec = RecordingJax()
    monkeypatch.setattr(jm, "jax", rec)
    monkeypatch.setattr(sys, "argv", ["profile_drqn.py"] + DRQN_ARGV)
    jm.main()
    runs = [c for c in rec.calls if c[0].__name__ == "run"]
    assert len(runs) == 2 * len(JAX_DRQN_ORDER)
    want = {name: float(runs[2 * i][2])
            for i, name in enumerate(JAX_DRQN_ORDER)}
    full_args = runs[2 * JAX_DRQN_ORDER.index("full")][1]
    assert len(full_args) == 6  # key, params, targets, opts, state, hid

    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.parallel import VecGridWorld

    spec = VecGridWorld(battle.get_config(20), [10, 10], 2,
                        device="cpu").spec
    template = [DRQNNet(spec.view_space(g), spec.feature_size(g),
                        spec.groups[g].type.n_action, state_size=16)
                for g in range(2)]
    nets = port_nets_from_flax(template, full_args[1])
    got = profile_drqn.main(DRQN_ARGV + ["--device", "cpu"], nets=nets)
    assert list(got) == list(profile_drqn.VARIANTS) == list(JAX_DRQN_ORDER)
    for name, (_, sink) in got.items():
        _close(name, sink, want[name])
    assert want["rollout"] > 0


class _Interpreted:
    """The JAX ``ops.window_gather`` module with its banded gather in
    interpret mode."""

    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        return getattr(self.module, name)

    def window_gather_banded(self, *args, **kwargs):
        return self.module.window_gather_banded(*args, interpret=True,
                                                **kwargs)


def test_profile_banded_sinks_match_jax(monkeypatch):
    """2 envs x 64 windows of 11 x 11 x 5 (map 35), 2 iterations per
    call: full, fixed_pos, fixed_img, kernel (the band-order form) and
    sort; pack and unsort print that they are fused."""
    argv = ["--n_envs", "2", "--per_env", "64", "--steps", "2", "--calls",
            "1", "full", "fixed_pos", "fixed_img", "kernel", "sort"]
    jm = jax_script("scripts/profile_banded.py")
    rec = RecordingJax()
    monkeypatch.setattr(jm, "jax", rec)
    # the Pallas kernel runs on the CPU in interpret mode only
    monkeypatch.setattr(jm, "wg", _Interpreted(jm.wg))
    monkeypatch.setattr(sys, "argv", ["profile_banded.py"] + argv)
    jm.main()
    runs = [float(out) for fn, _, out in rec.calls if fn.__name__ == "run"]
    order = ("full", "fixed_pos", "fixed_img", "kernel", "sort")
    want = {name: runs[2 * i] for i, name in enumerate(order)}
    got = profile_banded.main(argv + ["pack", "unsort", "--device", "cpu"])
    assert got["pack"] is None and got["unsort"] is None
    for name in order:
        _close(name, got[name][1], want[name])
    assert torch.isfinite(torch.tensor([v[1] for k, v in got.items()
                                        if v is not None])).all()


def test_profile_banded_plain_matches_jax_xla(monkeypatch):
    """The port's ``plain`` (``window_gather_ref``) against the JAX
    script's opt-in ``xla`` (``window_gather_xla``) at the size above: the
    same moved positions, sinks within rtol 1e-5."""
    argv = ["--n_envs", "2", "--per_env", "64", "--steps", "2", "--calls",
            "1"]
    jm = jax_script("scripts/profile_banded.py")
    rec = RecordingJax()
    monkeypatch.setattr(jm, "jax", rec)
    monkeypatch.setattr(sys, "argv", ["profile_banded.py"] + argv + ["xla"])
    jm.main()
    runs = [float(out) for fn, _, out in rec.calls if fn.__name__ == "run"]
    assert len(runs) == 2
    got = profile_banded.main(argv + ["plain", "--device", "cpu"])
    assert list(got) == ["plain"]
    assert got["plain"][1] == pytest.approx(runs[0], rel=1e-5)
    assert runs[0] > 0
