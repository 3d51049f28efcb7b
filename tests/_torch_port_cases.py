"""Shared set-up of the port-vs-JAX parity tests: paired JAX and port
VecGridWorlds on one config, and state conversion between the packages
through numpy (the port's state carry-over)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.builtin.config import battle as jbattle
from magent_tpu.builtin.config import forest as jforest
from magent_tpu.builtin.config import pursuit as jpursuit
from magent_tpu.core.state import State as JState
from magent_tpu.parallel import VecGridWorld as JVec

from magent_tpu_torch import random as trandom
from magent_tpu_torch.builtin.config import battle as tbattle
from magent_tpu_torch.builtin.config import forest as tforest
from magent_tpu_torch.builtin.config import pursuit as tpursuit
from magent_tpu_torch.core.state import FIELDS, state_from_numpy, state_to_numpy
from magent_tpu_torch.parallel import VecGridWorld as TVec

# (port config, JAX config) constructors, each package's own copy
CONFIGS = {
    "battle": (tbattle.get_config, jbattle.get_config),
    "forest": (tforest.get_config, jforest.get_config),
    "pursuit": (tpursuit.get_config, jpursuit.get_config),
}


class Pair:
    """A JAX and a port VecGridWorld of one config (port on the CPU), with
    the JAX functions jitted once.  A <= 1024 keeps the JAX package on its
    gridless quad path off-TPU (engine._use_quad).  ``name`` is a key of
    CONFIGS, or a pair of (port, JAX) ``map_size -> Config`` constructors."""

    def __init__(self, name, map_size, caps, n_envs, placements=None,
                 walls=None):
        port_cfg, jax_cfg = CONFIGS[name] if isinstance(name, str) else name
        self.jv = JVec(jax_cfg(map_size), caps, n_envs=n_envs,
                       placements=placements, walls=walls)
        self.tv = TVec(port_cfg(map_size), caps, n_envs=n_envs,
                       placements=placements, walls=walls, device="cpu")
        self.spec = self.tv.spec
        self.reset = jax.jit(self.jv.reset)
        self.step = jax.jit(self.jv.step)
        self.transition = jax.jit(self.jv.transition)
        self.observe_all = jax.jit(self.jv.observe_all)
        self.random_actions = jax.jit(self.jv.random_actions,
                                      static_argnames="fast")


def arrays_of(js) -> dict:
    """JAX State -> dict of numpy arrays."""
    return {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}


def jax_state(arrays) -> JState:
    return JState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def port_state(arrays):
    return state_from_numpy(arrays, "cpu")


def assert_states_equal(ts, js, tag=""):
    """Every field equal, exactly, with the JAX dtype."""
    got = state_to_numpy(ts)
    want = arrays_of(js) if not isinstance(js, dict) else js
    for name in FIELDS:
        assert got[name].dtype == want[name].dtype, (tag, name)
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg="%s field %s" % (tag, name))


def perturb(arrays, spec, seed, dead_frac=0.1, low_hp=0.3):
    """Random hp in [low_hp, hp_max) and a fraction of dead agents."""
    rng = np.random.RandomState(seed)
    out = dict(arrays)
    hp_max = spec.s_hp_max[None, :]
    B, A = arrays["hp"].shape
    out["hp"] = (low_hp + rng.uniform(size=(B, A)) * (hp_max - low_hp)).astype(
        np.float32)
    out["dead"] = rng.uniform(size=(B, A)) < dead_frac
    return out


def biased_actions(spec, B, seed, attack_frac=0.6):
    """Per-slot actions drawn with numpy: attacks with ``attack_frac`` where
    the slot's group can attack, else moves; a few out-of-range no-ops."""
    rng = np.random.RandomState(seed)
    A = spec.n_agents_cap
    base = spec.s_attack_base[None, :]
    n_act = spec.s_n_action[None, :]
    n_att = n_act - base
    move = rng.randint(0, 1 << 20, size=(B, A)) % base
    att = base + rng.randint(0, 1 << 20, size=(B, A)) % np.maximum(n_att, 1)
    pick_att = (rng.uniform(size=(B, A)) < attack_frac) & (n_att > 0)
    acts = np.where(pick_att, att, move)
    acts = np.where(rng.uniform(size=(B, A)) < 0.03, n_act, acts)
    return acts.astype(np.int32)


def minimap_channels(spec, group):
    """Observed channels that hold pooled minimap maps."""
    if not spec.minimap_mode:
        return []
    perm = spec.channel_perm(group)
    return sorted(int(perm[spec.group2channel(g)]) + 2
                  for g in range(spec.n_groups))


# pooled minimap fractions are a count over a total; the JAX package's
# compiler may fuse that division with the window epilogue differently from
# the port's eager ops, so they get one ulp-scale allowance.  Every other
# view value is a masked copy of a rendered cell: exact.
MINIMAP_ATOL = 1e-6


def assert_obs_equal(t_obs, j_obs, spec, tag=""):
    for g, ((tv, tf), (jv, jf)) in enumerate(zip(t_obs, j_obs)):
        tv, tf = tv.numpy(), tf.numpy()
        jv, jf = np.asarray(jv), np.asarray(jf)
        assert tv.shape == jv.shape and tf.shape == jf.shape, (tag, g)
        mm = minimap_channels(spec, g)
        other = [c for c in range(tv.shape[-1]) if c not in mm]
        np.testing.assert_array_equal(tv[..., other], jv[..., other],
                                      err_msg="%s group %d views" % (tag, g))
        if mm:
            np.testing.assert_allclose(tv[..., mm], jv[..., mm],
                                       atol=MINIMAP_ATOL, rtol=0,
                                       err_msg="%s group %d minimap" % (tag, g))
        np.testing.assert_array_equal(tf, jf,
                                      err_msg="%s group %d features" % (tag, g))


def key_pair(seed):
    """The same key in both packages."""
    return jax.random.PRNGKey(seed), trandom.PRNGKey(seed)


def split_pair(jkey, tkey):
    jk, jsub = jax.random.split(jkey)
    tks = trandom.split(tkey)
    return (jk, jsub), (tks[0], tks[1])


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch intra-op thread while a module runs.  Modules of many
    mid-sized torch ops open an OpenMP region over every core per op; when
    several test workers share the cores those regions' barriers stall for
    the scheduler (a file of seconds alone took minutes beside five other
    workers).  Integer results are the same on any number of threads, and
    so are float sums of at most two terms; the tests that use this state
    their float tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
