"""Shared set-up of the reward-rule parity tests: the random rule ASTs of
``tests/test_rules_general.py`` (its generator, imported unedited) carried
into the port's config DSL, random [B, A] rule states, and the evaluation
of one package's plans on them (the JAX plans vmapped over B, the port's
on the batch)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from magent_tpu import config as jconfig
from magent_tpu import spec as jspec

import magent_tpu_torch as tmagent
from magent_tpu_torch import config as tconfig
from magent_tpu_torch import spec as tspec
from magent_tpu_torch.core import rules as trules

from _torch_port_cases import jax_state, port_state
from test_rules_general import (CAPS, MAP, _base_config, _collect_syms,
                                _random_ast, _random_state)

B = 3


def port_base_config():
    """``test_rules_general._base_config`` in the port's DSL."""
    gw = tmagent.gridworld
    cfg = gw.Config()
    cfg.set({"map_width": MAP, "map_height": MAP})
    t = cfg.register_agent_type(
        "t", {"width": 1, "length": 1, "hp": 5, "speed": 1,
              "view_range": gw.CircleRange(2),
              "attack_range": gw.CircleRange(1), "damage": 1})
    cfg.add_group(t)
    cfg.add_group(t)
    return cfg


class PortAst:
    """Carries JAX rule ASTs into the port's classes; a symbol shared by
    several nodes or rules stays one port symbol (plans compare symbols by
    identity)."""

    def __init__(self):
        self.memo = {}

    def symbol(self, sym):
        if id(sym) not in self.memo:
            index = {-1: "any", -2: "all"}.get(sym.index, sym.index)
            self.memo[id(sym)] = (sym, tconfig.AgentSymbol(sym.group, index))
        return self.memo[id(sym)][1]

    def node(self, node):
        out = tconfig.EventNode()
        out.op = node.op
        out.inputs = [self.node(x) if isinstance(x, jconfig.EventNode)
                      else self.symbol(x) if isinstance(x, jconfig.AgentSymbol)
                      else x for x in node.inputs]
        return out

    def add_rules(self, jcfg, tcfg):
        for on, receivers, values, terminal in jcfg.reward_rules:
            tcfg.add_reward_rule(self.node(on),
                                 receiver=[self.symbol(r) for r in receivers],
                                 value=list(values), terminal=terminal)


def random_rule_configs(seed):
    """``test_rules_general._one_case``'s configs of ``seed`` in both
    packages, and the rng that then draws its states."""
    rng = random.Random(seed)
    jcfg = _base_config()
    pool = []
    for _ in range(rng.randrange(1, 3)):
        ast = _random_ast(rng, rng.randrange(0, 3), pool)
        syms = []
        _collect_syms(ast, syms)
        pool = list(dict.fromkeys(pool + syms))
        receivers, values = [], []
        for _ in range(rng.randrange(1, 3)):
            receivers.append(rng.choice(syms))
            values.append(round(rng.uniform(-2, 2), 2))
        jcfg.add_reward_rule(ast, receiver=receivers, value=values,
                             terminal=rng.random() < 0.2)
    tcfg = port_base_config()
    PortAst().add_rules(jcfg, tcfg)
    return jcfg, tcfg, rng


def general_plans(spec):
    """Every rule of a port spec built as :class:`GeneralRule` (the JAX
    package's ``MAGENT_RULES=general``)."""
    order = trules._symbol_order(spec.reward_rules)
    return [trules.GeneralRule(spec, on, r, v, t, order.index)
            for on, r, v, t in spec.reward_rules]


def batch_arrays(spec, per_env, seed):
    """Full state arrays ``[B, ...]`` from ``_random_state`` dicts (one per
    env), with random rewards carried in so the plans add onto them."""
    rng = np.random.RandomState(seed)
    A, G, H, W = spec.n_agents_cap, spec.n_groups, spec.height, spec.width
    n = len(per_env)
    stack = {k: np.stack([s[k] for s in per_env]) for k in per_env[0]}
    return {
        "cell_slot": np.full((n, H, W), -1, np.int32),
        "cell_wall": np.zeros((n, H, W), bool),
        "cell_food": np.zeros((n, H, W), np.float32),
        "x": stack["x"], "y": stack["y"],
        "dir": np.zeros((n, A), np.int32),
        "hp": np.ones((n, A), np.float32),
        "active": stack["active"], "dead": stack["dead"],
        "absorbed": np.zeros((n, A), bool),
        "id": np.zeros((n, A), np.int32),
        "last_action": np.zeros((n, A), np.int32),
        "next_reward": rng.normal(size=(n, A)).astype(np.float32),
        "last_reward": np.zeros((n, A), np.float32),
        "last_op": stack["last_op"], "op_obj": stack["op_obj"],
        "group_reward": rng.normal(size=(n, G)).astype(np.float32),
        "n_in_group": np.zeros((n, G), np.int32),
        "lcg": np.ones(n, np.uint32),
        "key": np.zeros((n, 2), np.uint32),
        "done": np.zeros(n, bool),
        "id_counter": np.full(n, A, np.int32),
        "step_ct": np.zeros(n, np.int32),
    }


def random_batch(spec, rng, seed):
    """B draws of ``_random_state`` from ``rng``, as full arrays."""
    return batch_arrays(spec, [_random_state(rng, spec) for _ in range(B)],
                        seed)


def apply_jax(plans, spec, arrays):
    """The JAX plans in order, vmapped over the env axis -> numpy
    (next_reward, group_reward, [triggered per plan])."""
    js = jax_state(arrays)
    nr = jnp.asarray(arrays["next_reward"])
    gr = jnp.asarray(arrays["group_reward"])
    trig = []
    for p in plans:
        nr, gr, t = jax.vmap(
            lambda st, a, b, p=p: p.apply(spec, st, a, b))(js, nr, gr)
        trig.append(np.asarray(t))
    return np.asarray(nr), np.asarray(gr), trig


def apply_port(plans, spec, arrays):
    """The port's plans in order on the batch -> numpy (next_reward,
    group_reward, [triggered per plan])."""
    ts = port_state(arrays)
    nr = torch.from_numpy(arrays["next_reward"])
    gr = torch.from_numpy(arrays["group_reward"])
    trig = []
    for p in plans:
        nr, gr, t = p.apply(spec, ts, nr, gr)
        trig.append(t.cpu().numpy())
    return nr.cpu().numpy(), gr.cpu().numpy(), trig


def assert_same(got, want, tag):
    """(next_reward, group_reward, triggered) equal, exactly."""
    np.testing.assert_array_equal(got[0], want[0], err_msg=tag + " rewards")
    np.testing.assert_array_equal(got[1], want[1],
                                  err_msg=tag + " group rewards")
    assert len(got[2]) == len(want[2]), tag
    for k, (g, w) in enumerate(zip(got[2], want[2])):
        np.testing.assert_array_equal(g, w, err_msg="%s rule %d triggered"
                                      % (tag, k))


def compile_both(jcfg, tcfg, caps):
    """Both packages' compiled plans, or the exception type both raised."""
    out = []
    for spec_mod, cfg in ((jspec, jcfg), (tspec, tcfg)):
        try:
            sp = spec_mod.compile_spec(cfg, caps)
            out.append((sp, sp.compiled_rules()))
        except (NotImplementedError, ValueError) as e:
            out.append(type(e))
    return out

