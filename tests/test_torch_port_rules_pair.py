"""The port's ``PairSharedObjectRule`` against the JAX package's on B=3
random states: subjects of one group and of two groups, the same op and
two ops, receivers ``sub1``, ``sub2``, ``obj`` and a whole group, a
fixed-index object (a plan built directly: the compiler routes that shape
to ``GeneralRule``), and double_attack's own rule with three or more
tigers on one deer (each tiger paid 2 (k - 1): the receivers ``a`` and
``b`` each take its ordered pairs).  Degrees are counts of 1.0 and every
reward the same f32 products added in the same order: exact."""

import numpy as np
import pytest

from magent_tpu import spec as jspec
from magent_tpu.builtin.config import double_attack as jdouble
from magent_tpu.core import rules as jrules

from magent_tpu_torch import spec as tspec
from magent_tpu_torch.builtin.config import double_attack as tdouble
from magent_tpu_torch.core import rules as trules
from magent_tpu_torch.spec import OP_ATTACK, OP_COLLIDE, OP_KILL, OP_NULL

import magent_tpu as jmagent
import magent_tpu_torch as tmagent

from _torch_rule_cases import (PortAst, apply_jax, apply_port, assert_same,
                               batch_arrays)

CAPS = [7, 6, 4]
MAP = 12

# (sub1 group, op1, sub2 group, op2, receivers by name)
PAIRS = {
    "one group, one op": (0, "attack", 0, "attack", ["a", "b"]),
    "one group, two ops": (0, "attack", 0, "kill", ["a", "b", "c"]),
    "two groups, one op": (0, "attack", 1, "attack", ["a", "c", "g0"]),
    "two groups, two ops": (0, "collide", 1, "attack", ["b", "c", "g1"]),
}


def _config(magent, case):
    gw = magent.gridworld
    cfg = gw.Config()
    cfg.set({"map_width": MAP, "map_height": MAP})
    t = cfg.register_agent_type("t", {"hp": 5, "view_range": gw.CircleRange(2),
                                      "attack_range": gw.CircleRange(1),
                                      "damage": 1})
    groups = [cfg.add_group(t) for _ in CAPS]
    g1, op1, g2, op2, names = PAIRS[case]
    syms = {"a": gw.AgentSymbol(groups[g1], index="any"),
            "b": gw.AgentSymbol(groups[g2], index="any"),
            "c": gw.AgentSymbol(groups[2], index="any"),
            "g0": gw.AgentSymbol(groups[0], index="all"),
            "g1": gw.AgentSymbol(groups[1], index="all")}
    on = gw.Event(syms["a"], op1, syms["c"]) & \
        gw.Event(syms["b"], op2, syms["c"])
    values = [0.5, -1.25, 0.3][:len(names)]
    cfg.add_reward_rule(on, receiver=[syms[n] for n in names], value=values)
    return cfg


def _pile_arrays(spec, seed, piles=(0, 1)):
    """Random states whose attackers pile onto few objects: every slot
    records ATTACK, KILL, COLLIDE or nothing on one of group 2's slots
    ``piles`` (or on a random slot, or none)."""
    rng = np.random.RandomState(seed)
    A = spec.n_agents_cap
    c0 = spec.groups[2].offset
    per_env = []
    for _ in range(3):
        last_op = rng.choice([OP_NULL, OP_ATTACK, OP_KILL, OP_COLLIDE], A,
                             p=[0.1, 0.4, 0.25, 0.25]).astype(np.int32)
        target = np.where(rng.uniform(size=A) < 0.8,
                          c0 + rng.choice(piles, A), rng.randint(-1, A, A))
        per_env.append(dict(
            x=rng.randint(1, MAP - 1, A).astype(np.int32),
            y=rng.randint(1, MAP - 1, A).astype(np.int32),
            active=rng.uniform(size=A) < 0.9,
            dead=rng.uniform(size=A) < 0.1,
            last_op=last_op,
            op_obj=np.where(last_op == OP_NULL, -1, target).astype(np.int32)))
    return batch_arrays(spec, per_env, seed)


@pytest.mark.parametrize("case", sorted(PAIRS))
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_rule_matches_jax(case, seed):
    jsp = jspec.compile_spec(_config(jmagent, case), CAPS)
    tsp = tspec.compile_spec(_config(tmagent, case), CAPS)
    jplans, tplans = jsp.compiled_rules(), tsp.compiled_rules()
    assert isinstance(jplans[0], jrules.PairSharedObjectRule)
    assert isinstance(tplans[0], trules.PairSharedObjectRule)
    arrays = _pile_arrays(tsp, seed)
    got = apply_port(tplans, tsp, arrays)
    assert_same(got, apply_jax(jplans, jsp, arrays), case)
    assert got[2][0].any()  # the piles trigger


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_rule_fixed_index_object_matches_jax(seed):
    """A fixed-index object (group 2's slot 1), every receiver kind."""
    case = "two groups, two ops"
    jsp = jspec.compile_spec(_config(jmagent, case), CAPS)
    tsp = tspec.compile_spec(_config(tmagent, case), CAPS)
    on, _, _, _ = jsp.reward_rules[0]
    a, c = on.inputs[0].inputs
    b = on.inputs[1].inputs[0]
    fixed = type(c)(c.group, 1)
    whole = type(c)(0, "all")
    carry = PortAst()
    plans = []
    for rules, syms in ((jrules, (a, b, fixed, whole)),
                        (trules, tuple(carry.symbol(s)
                                       for s in (a, b, fixed, whole)))):
        plans.append(rules.PairSharedObjectRule(
            None, OP_ATTACK, OP_KILL, syms[0], syms[1], syms[2],
            list(syms), [0.5, -1.25, 0.3, 2.0], False))
    arrays = _pile_arrays(tsp, seed, piles=(1, 1, 2))
    got = apply_port(plans[1:], tsp, arrays)
    assert_same(got, apply_jax(plans[:1], jsp, arrays), "fixed object")
    assert got[2][0].any()


def test_double_attack_pays_each_tiger_twice_its_partners():
    """k tigers on one deer: each earns 2 (k - 1) (ordered pairs, receivers
    a and b); a deer attacked by one tiger pays nothing."""
    caps = [4, 8]
    jsp = jspec.compile_spec(jdouble.get_config(20), caps)
    tsp = tspec.compile_spec(tdouble.get_config(20), caps)
    A = tsp.n_agents_cap
    t0 = tsp.groups[1].offset
    target = np.full(A, -1, np.int32)
    target[t0:t0 + 4] = 1      # four tigers on deer 1
    target[t0 + 4:t0 + 7] = 0  # three on deer 0
    target[t0 + 7] = 2         # one alone on deer 2
    per_env = [dict(x=np.arange(A, dtype=np.int32) % 20,
                    y=np.arange(A, dtype=np.int32) // 20,
                    active=np.ones(A, bool), dead=np.zeros(A, bool),
                    last_op=np.where(target >= 0, OP_ATTACK,
                                     OP_NULL).astype(np.int32),
                    op_obj=target)]
    arrays = batch_arrays(tsp, per_env * 3, 0)
    arrays["next_reward"][:] = 0.0
    arrays["group_reward"][:] = 0.0
    arrays["active"][2, t0:t0 + 2] = False  # env 2: two of the four gone
    jplans, tplans = jsp.compiled_rules(), tsp.compiled_rules()
    assert isinstance(tplans[0], trules.PairSharedObjectRule)
    got = apply_port(tplans, tsp, arrays)
    assert_same(got, apply_jax(jplans, jsp, arrays), "double_attack")
    want = np.zeros(A, np.float32)
    want[t0:t0 + 4], want[t0 + 4:t0 + 7] = 6.0, 4.0
    np.testing.assert_array_equal(got[0][0], want)
    want[t0:t0 + 2], want[t0 + 2:t0 + 4] = 0.0, 2.0
    np.testing.assert_array_equal(got[0][2], want)
