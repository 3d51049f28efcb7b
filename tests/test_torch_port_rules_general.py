"""The port's rule compiler against the JAX package's on random rule ASTs:
``tests/test_rules_general.py``'s generator (caps [5, 6], map 12, seeds
0-119), compiled (each rule on the same plan type in both packages) and
forced onto ``GeneralRule`` (JAX through ``MAGENT_RULES=general``, the port
by building ``GeneralRule`` directly), each evaluated on B=3 random states;
the chunked join with ``MAX_TENSOR`` = 8 in both packages (caps [5, 7],
seeds 0-59), its ragged-tail regression and four 'any' axes; the
compile-time errors.

Rewards are the same f32 products added in the same order (the port's
blocks follow the JAX package's block grid; its scatter-adds run in index
order on the CPU, as XLA's do): every comparison is exact."""

import random

import numpy as np
import pytest

from magent_tpu import spec as jspec
from magent_tpu.config import AgentSymbol as JSym
from magent_tpu.config import EventNode as JNode
from magent_tpu.core import rules as jrules

from magent_tpu_torch import spec as tspec
from magent_tpu_torch.config import AgentSymbol as TSym
from magent_tpu_torch.config import EventNode as TNode
from magent_tpu_torch.core import rules as trules
from magent_tpu_torch.spec import OP_AND, OP_ATTACK, OP_IN

from _torch_rule_cases import (CAPS, MAP, PortAst, apply_jax, apply_port,
                               assert_same, batch_arrays, compile_both,
                               general_plans, port_base_config, random_batch,
                               random_rule_configs)
from test_rules_general import _base_config, _random_state


def _sweep_case(seed, force_general, caps, monkeypatch):
    """One seed of the sweep: None where neither package compiles the
    rules, else True after holding every plan against the JAX plan."""
    jcfg, tcfg, rng = random_rule_configs(seed)
    with monkeypatch.context() as m:
        if force_general:
            m.setenv("MAGENT_RULES", "general")
        else:
            m.delenv("MAGENT_RULES", raising=False)
        jres, tres = compile_both(jcfg, tcfg, caps)
    if force_general and not isinstance(tres, type):
        try:
            tres = (tres[0], general_plans(tres[0]))
        except (NotImplementedError, ValueError) as e:
            tres = type(e)
    if isinstance(jres, type) or isinstance(tres, type):
        assert jres == tres, "seed %d: JAX %s, port %s" % (seed, jres, tres)
        return None
    (jsp, jplans), (tsp, tplans) = jres, tres
    assert [type(p).__name__ for p in tplans] == \
        [type(p).__name__ for p in jplans], "seed %d" % seed
    assert [p.is_terminal for p in tplans] == [p.is_terminal for p in jplans]
    for tp, jp in zip(tplans, jplans):
        if isinstance(jp, jrules.GeneralRule):
            assert tp.chunk_sizes == list(jp.chunk_sizes), "seed %d" % seed
            assert tp.never_fires == jp.never_fires, "seed %d" % seed
    arrays = random_batch(tsp, rng, seed)
    assert_same(apply_port(tplans, tsp, arrays),
                apply_jax(jplans, jsp, arrays), "seed %d" % seed)
    return True


@pytest.mark.parametrize("force_general", [False, True],
                         ids=["compiled", "general"])
def test_random_rules_match_jax(force_general, monkeypatch):
    ran = sum(bool(_sweep_case(seed, force_general, CAPS, monkeypatch))
              for seed in range(120))
    assert ran > 60, "only %d cases were evaluable" % ran


def test_random_rules_compile_to_jax_plan_types(monkeypatch):
    """Every rule shape the JAX package compiles, the port compiles to the
    same plan type; the three plan types all occur."""
    monkeypatch.delenv("MAGENT_RULES", raising=False)
    seen = set()
    for seed in range(120):
        jcfg, tcfg, _ = random_rule_configs(seed)
        jres, tres = compile_both(jcfg, tcfg, CAPS)
        if isinstance(jres, type):
            assert tres == jres, seed
            continue
        names = [type(p).__name__ for p in tres[1]]
        assert names == [type(p).__name__ for p in jres[1]], seed
        seen.update(names)
    assert {"SingleSubjectRule", "GeneralRule"} <= seen


@pytest.mark.parametrize("max_tensor", [8, 2])
def test_chunked_join_matches_jax(monkeypatch, max_tensor):
    """MAX_TENSOR = 8 in both packages: every multi-axis join chunks, with
    ragged tails on both groups (caps [5, 7]); at 2, one-axis joins chunk
    too."""
    monkeypatch.setattr(jrules.GeneralRule, "MAX_TENSOR", max_tensor)
    monkeypatch.setattr(trules.GeneralRule, "MAX_TENSOR", max_tensor)
    ran = sum(bool(_sweep_case(seed, True, [5, 7], monkeypatch))
              for seed in range(60))
    assert ran > 30, "only %d cases were evaluable" % ran


def _in_box(sym, box, node_cls):
    node = node_cls()
    node.op = OP_IN
    node.inputs = [sym, *box]
    return node


def _and(a, b, node_cls):
    node = node_cls()
    node.op = OP_AND
    node.inputs = [a, b]
    return node


def _both_specs(build, caps):
    """One rule set built with the JAX classes, carried into the port."""
    jcfg = _base_config()
    build(jcfg)
    tcfg = port_base_config()
    PortAst().add_rules(jcfg, tcfg)
    return jspec.compile_spec(jcfg, caps), tspec.compile_spec(tcfg, caps)


def test_chunked_ragged_tail_on_last_group(monkeypatch):
    """``test_rules_general.py``'s ragged-tail regression: group 1's axis
    (cap 7) chunks into blocks of 2 under MAX_TENSOR = 8, and its last
    block (group start 6) slices slots [11, 13) of a 12-slot array; slot 11
    is inactive and slot 10 active, so a shifted or truncated slice pays
    the wrong slot or drops the block."""
    monkeypatch.setattr(jrules.GeneralRule, "MAX_TENSOR", 8)
    monkeypatch.setattr(trules.GeneralRule, "MAX_TENSOR", 8)
    monkeypatch.setenv("MAGENT_RULES", "general")

    def build(cfg):
        a0, a1 = JSym(0, "any"), JSym(1, "any")
        box = (0, 0, MAP - 1, MAP - 1)
        cfg.add_reward_rule(_and(_in_box(a0, box, JNode),
                                 _in_box(a1, box, JNode), JNode),
                            receiver=[a1], value=[-2.5])

    jsp, tsp = _both_specs(build, [5, 7])
    jplans, tplans = jsp.compiled_rules(), general_plans(tsp)
    assert tplans[0].chunk_sizes == list(jplans[0].chunk_sizes)
    assert len(tplans[0].blocks(tsp)) > 1
    rng = random.Random(0)
    per_env = []
    for k in range(3):
        s = _random_state(rng, tsp)
        s["active"][:] = False
        s["active"][0] = True          # group 0: one live agent
        s["active"][5:11 - k] = True   # group 1: slot 11 inactive
        s["dead"][:] = False
        per_env.append(s)
    arrays = batch_arrays(tsp, per_env, 0)
    arrays["next_reward"][:] = 0.0
    got = apply_port(tplans, tsp, arrays)
    assert_same(got, apply_jax(jplans, jsp, arrays), "ragged tail")
    assert got[0][0, 10] == -2.5 and got[0][0, 11] == 0.0


@pytest.mark.parametrize("max_tensor", [None, 8])
def test_four_any_axes(monkeypatch, max_tensor):
    """Four 'any' axes, two per group (exclusivity on both), dense when it
    fits and in blocks of at most 8 when forced small."""
    if max_tensor is not None:
        monkeypatch.setattr(jrules.GeneralRule, "MAX_TENSOR", max_tensor)
        monkeypatch.setattr(trules.GeneralRule, "MAX_TENSOR", max_tensor)

    def build(cfg):
        syms = [JSym(0, "any"), JSym(1, "any"), JSym(0, "any"),
                JSym(1, "any")]
        boxes = [(0, 0, MAP - 1, MAP - 1), (0, 0, MAP - 1, MAP - 1),
                 (0, 0, 8, 8), (2, 2, MAP - 1, MAP - 1)]
        leaves = [_in_box(s, b, JNode) for s, b in zip(syms, boxes)]
        root = _and(_and(leaves[0], leaves[1], JNode),
                    _and(leaves[2], leaves[3], JNode), JNode)
        cfg.add_reward_rule(root, receiver=[syms[0], syms[3]],
                            value=[0.5, -0.25])

    jsp, tsp = _both_specs(build, CAPS)
    jplans, tplans = jsp.compiled_rules(), tsp.compiled_rules()
    assert isinstance(tplans[0], trules.GeneralRule)
    assert tplans[0].chunk_sizes == list(jplans[0].chunk_sizes)
    fired = 0
    for seed in range(4):
        rng = random.Random(100 + seed)
        per_env = [_random_state(rng, tsp) for _ in range(3)]
        for s in per_env:
            s["active"][:] = True
        arrays = batch_arrays(tsp, per_env, seed)
        got = apply_port(tplans, tsp, arrays)
        assert_same(got, apply_jax(jplans, jsp, arrays), "seed %d" % seed)
        fired += int(np.any(got[0] != arrays["next_reward"]))
    assert fired


def test_all_object_of_binary_leaf_raises():
    """The reference asserts that an attack's object is no group: both
    packages refuse it at compile time."""
    for spec_mod, build_cfg, sym_cls, node_cls in (
            (jspec, _base_config, JSym, JNode),
            (tspec, port_base_config, TSym, TNode)):
        cfg = build_cfg()
        a, g = sym_cls(0, "any"), sym_cls(1, "all")
        node = node_cls()
        node.op = OP_ATTACK
        node.inputs = [a, g]
        cfg.add_reward_rule(node, receiver=a, value=1.0)
        with pytest.raises(ValueError, match="group"):
            spec_mod.compile_spec(cfg, CAPS).compiled_rules()


def test_fixed_receiver_outside_event_rejected():
    """A fixed-index receiver the event does not bind has no defined
    semantics: both packages route it to GeneralRule, which raises."""
    for spec_mod, build_cfg, sym_cls, node_cls in (
            (jspec, _base_config, JSym, JNode),
            (tspec, port_base_config, TSym, TNode)):
        cfg = build_cfg()
        node = node_cls()
        node.op = OP_ATTACK
        node.inputs = [sym_cls(0, "any"), sym_cls(1, "any")]
        cfg.add_reward_rule(node, receiver=sym_cls(1, 0), value=1.0)
        with pytest.raises(NotImplementedError, match="receiver"):
            spec_mod.compile_spec(cfg, CAPS).compiled_rules()


@pytest.mark.parametrize("max_tensor", [None, 2])
def test_reward_adds_round_in_jax_order(monkeypatch, max_tensor):
    """Slots paid by several blocks, and objects paid by several subjects
    in one scatter, with inexact values (0.1, -0.3, 0.7) onto rewards of
    magnitude ~100: the sums round as the JAX package's do only when the
    adds come in its order (blocks in its grid order; duplicate objects in
    index order, added into the rewards one by one)."""
    if max_tensor is not None:
        monkeypatch.setattr(jrules.GeneralRule, "MAX_TENSOR", max_tensor)
        monkeypatch.setattr(trules.GeneralRule, "MAX_TENSOR", max_tensor)
    box = (0, 0, MAP - 1, MAP - 1)

    def build(cfg):
        a0, a1, c0 = JSym(0, "any"), JSym(1, "any"), JSym(0, "any")
        b1 = JSym(1, "any")
        cfg.add_reward_rule(_and(_in_box(a0, box, JNode),
                                 _in_box(a1, box, JNode), JNode),
                            receiver=[a0, a1], value=[0.1, -0.3])
        attack = JNode()
        attack.op = OP_ATTACK
        attack.inputs = [a0, b1]
        cfg.add_reward_rule(_and(attack, _in_box(c0, box, JNode), JNode),
                            receiver=[b1, a0], value=[0.1, 0.7])

    jsp, tsp = _both_specs(build, [5, 7])
    jplans, tplans = jsp.compiled_rules(), tsp.compiled_rules()
    assert [type(p) for p in tplans] == [trules.GeneralRule] * 2
    if max_tensor is not None:
        assert min(len(p.blocks(tsp)) for p in tplans) > 2
    rng = np.random.RandomState(3)
    A = tsp.n_agents_cap
    per_env = []
    for _ in range(3):
        target = 5 + rng.randint(0, 2, A)  # piles on group 1's first two
        per_env.append(dict(
            x=rng.randint(1, MAP - 1, A).astype(np.int32),
            y=rng.randint(1, MAP - 1, A).astype(np.int32),
            active=np.ones(A, bool), dead=np.zeros(A, bool),
            last_op=np.full(A, OP_ATTACK, np.int32),
            op_obj=target.astype(np.int32)))
    arrays = batch_arrays(tsp, per_env, 3)
    arrays["next_reward"] *= 100.0
    got = apply_port(tplans, tsp, arrays)
    assert_same(got, apply_jax(jplans, jsp, arrays), "rounding order")
    assert all(t.all() for t in got[2])
