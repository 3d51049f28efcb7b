"""One engine step of the port against the JAX package's gridless step, on
equal state, actions and key, over several seeds of dense layouts (shared
attack targets, kills, contested and blocked moves).  Every state field is
compared exactly: the step is integer logic plus the same f32 elementwise
ops in the same order (battle's damage sums are exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.spec import OP_ATTACK, OP_COLLIDE, OP_KILL

from _torch_port_cases import (Pair, arrays_of, assert_states_equal,
                               biased_actions, jax_state, key_pair, perturb,
                               port_state)

B = 3
# dense layouts: 2x60 agents on a 14x14 interior
SETUPS = {"battle": (16, [60, 60]), "forest": (16, [60, 60])}
SEEDS = [0, 1, 2, 3]


@pytest.fixture(scope="module", params=sorted(SETUPS))
def pair(request):
    map_size, caps = SETUPS[request.param]
    p = Pair(request.param, map_size, caps, B)
    p.port_step = tengine.make_step(p.spec, maintain_grid=False, n_envs=B)
    p.name = request.param
    return p


@pytest.mark.parametrize("seed", SEEDS)
def test_step_matches_jax(pair, seed):
    spec = pair.spec
    jkey, _ = key_pair(seed)
    arrays = perturb(arrays_of(pair.reset(jkey)), spec, seed)
    actions = biased_actions(spec, B, seed)

    js = pair.step(jax_state(arrays), jnp.asarray(actions))
    ts = pair.port_step(port_state(arrays), torch.from_numpy(actions))
    assert_states_equal(ts, js, "seed %d" % seed)

    # battle's case exercises the pairwise paths: kills, shared targets,
    # collisions (forest's tigers are too few per deer to promise all three)
    if pair.name != "battle":
        return
    op = np.asarray(js.last_op)
    obj = np.asarray(js.op_obj)
    assert (op == OP_KILL).sum() > 0
    assert (op == OP_COLLIDE).sum() > 0
    hit = (op == OP_ATTACK) | (op == OP_KILL)
    shared = sum(len(t) - len(set(t)) for t in
                 (obj[b][hit[b]].tolist() for b in range(B)))
    assert shared > 0


def test_step_chain_matches_jax(pair):
    """Five raw steps in a row (no reward rotation between them) stay equal,
    so the key carried in the state advances the same way."""
    spec = pair.spec
    jkey, _ = key_pair(11)
    arrays = perturb(arrays_of(pair.reset(jkey)), spec, 11)
    js, ts = jax_state(arrays), port_state(arrays)
    for i in range(5):
        actions = biased_actions(spec, B, 100 + i)
        js = pair.step(js, jnp.asarray(actions))
        ts = pair.port_step(ts, torch.from_numpy(actions))
        assert_states_equal(ts, js, "step %d" % i)


def test_attack_rank_matches_jax_splitmix():
    """The attack priorities: a fresh threefry subkey mixed with the slot
    index (engine.py:1032-1037), reproduced in int64 words."""
    import jax

    A = 37
    jkey = jax.random.PRNGKey(9)
    key, sub = jax.random.split(jkey)
    slot = jnp.arange(A, dtype=jnp.uint32)
    z = sub[0].astype(jnp.uint32) + slot * jnp.uint32(0x9E3779B9)
    z = (z ^ (z >> 16)) * jnp.uint32(0x85EBCA6B)
    z = (z ^ (z >> 13)) * jnp.uint32(0xC2B2AE35)
    want = np.asarray(z ^ (z >> 16)).astype(np.int64)

    from magent_tpu_torch.core.state import State

    state = State(**{f: None for f in State.__dataclass_fields__})
    state = state.replace(key=torch.from_numpy(
        np.asarray(jkey).astype(np.int64))[None])
    next_key, rank = tengine.attack_rank(state, A)
    np.testing.assert_array_equal(rank[0].numpy(), want)
    np.testing.assert_array_equal(next_key[0].numpy(),
                                  np.asarray(key).astype(np.int64))
