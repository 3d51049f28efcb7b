"""The PyTorch port's static layer against the JAX package: compiled spec
tables, rule compilation, threefry random numbers, the state carry-over,
the package's independence from JAX, and its device policy."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from magent_tpu import spec as jspec
from magent_tpu.builtin.config import battle as jbattle
from magent_tpu.builtin.config import double_attack as jdouble
from magent_tpu.builtin.config import forest as jforest
from magent_tpu.builtin.config import pursuit as jpursuit
from magent_tpu.parallel import VecGridWorld as JVec

from magent_tpu_torch import random as trandom
from magent_tpu_torch import spec as tspec
from magent_tpu_torch.builtin.config import battle as tbattle
from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.core import rules as trules
from magent_tpu_torch.core.state import FIELDS, state_from_numpy, state_to_numpy
from magent_tpu_torch.parallel import VecGridWorld, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_value(a, b, where):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


# the other configs' Config objects come from the JAX package (the port
# has only battle's): the port's compiler reads them through the same DSL
# attributes
CONFIGS = {
    "battle": (lambda: tbattle.get_config(24), lambda: jbattle.get_config(24),
               [7, 5]),
    "forest": (lambda: jforest.get_config(24), lambda: jforest.get_config(24),
               [7, 5]),
    "pursuit": (lambda: jpursuit.get_config(24), lambda: jpursuit.get_config(24),
                [3, 6]),
    "double_attack": (lambda: jdouble.get_config(24),
                      lambda: jdouble.get_config(24), [4, 4]),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spec_tables_match_jax(name):
    """Every table and scalar of the compiled GameSpec equals the JAX one
    (exact: both are the same numpy computation)."""
    port_cfg, jax_cfg, caps = CONFIGS[name]
    t = tspec.compile_spec(port_cfg(), caps)
    j = jspec.compile_spec(jax_cfg(), caps)
    skip = {"types", "groups", "reward_rules", "_compiled_rules"}
    assert set(vars(t)) == set(vars(j))
    for key in sorted(set(vars(j)) - skip):
        _assert_same_value(getattr(t, key), getattr(j, key), key)
    for tg, jg in zip(t.groups, j.groups):
        assert (tg.group_id, tg.cap, tg.offset, tg.type.name) == (
            jg.group_id, jg.cap, jg.offset, jg.type.name)
        for key, value in vars(jg.type).items():
            tv = getattr(tg.type, key)
            if hasattr(value, "mask"):  # RangeMask
                for f in ("mask", "dx", "dy", "x1", "y1", "x2", "y2"):
                    _assert_same_value(getattr(tv, f), getattr(value, f),
                                       "%s.%s" % (key, f))
            else:
                _assert_same_value(tv, value, key)
        np.testing.assert_array_equal(tg.type.view2attack(),
                                      jg.type.view2attack())
    for g in range(j.n_groups):
        np.testing.assert_array_equal(t.channel_perm(g), j.channel_perm(g))
        assert t.feature_size(g) == j.feature_size(g)
        assert t.view_space(g) == j.view_space(g)
        assert t.action_space(g) == j.action_space(g)


def test_battle_rules_compile_to_single_subject_plans():
    spec = tspec.compile_spec(tbattle.get_config(24), [5, 5])
    plans = spec.compiled_rules()
    assert len(plans) == 2
    assert all(isinstance(p, trules.SingleSubjectRule) for p in plans)
    assert [p.subject.group for p in plans] == [0, 1]


def test_unported_rule_shapes_raise():
    """The two rule shapes that raised until the port had the JAX
    package's other plans now compile to them, in both packages:
    double_attack's to PairSharedObjectRule, three symbols in one event to
    GeneralRule."""
    from magent_tpu.core import rules as jrules
    from magent_tpu_torch.builtin.config import double_attack as tdouble

    for spec_mod, cfg, rules in (
            (tspec, tdouble.get_config(24), trules),
            (jspec, jdouble.get_config(24), jrules)):
        plans = spec_mod.compile_spec(cfg, [4, 4]).compiled_rules()
        assert [type(p) for p in plans] == [rules.PairSharedObjectRule]
    for spec_mod, battle_mod, rules in ((tspec, tbattle, trules),
                                        (jspec, jbattle, jrules)):
        gw = battle_mod.magent.gridworld
        cfg = battle_mod.get_config(24)
        cfg.add_group("small")
        a, b, c = (gw.AgentSymbol(g, index="any") for g in range(3))
        cfg.add_reward_rule(gw.Event(a, "attack", b)
                            | gw.Event(c, "attack", b), receiver=c, value=1.0)
        plans = spec_mod.compile_spec(cfg, [3, 3, 3]).compiled_rules()
        assert [type(p) for p in plans] == [rules.SingleSubjectRule] * 2 + [
            rules.GeneralRule]


def test_make_step_rejects_unported_specs():
    """Multi-cell bodies now build on the grid path; past the batched quad
    cap the step takes the grid path's sort branches, and a single world
    keeps the pair kernels up to QUAD_MAX_SINGLE.  Only turn mode raises
    (test_torch_port_grid_engine.py::test_unported_specs_raise)."""
    assert tengine.make_step(tspec.compile_spec(
        jpursuit.get_config(24), [3, 6])).route == tengine._Route(
            grid=True, quad=True)
    big = tspec.compile_spec(tbattle.get_config(200), [4100, 4100])
    assert tengine.make_step(big, maintain_grid=False, n_envs=16).route == \
        tengine._Route(grid=True, quad=False)
    assert tengine.make_step(big, maintain_grid=False, n_envs=1).route == \
        tengine._Route(grid=False, quad=True)
    huge = tspec.compile_spec(tbattle.get_config(200), [8200, 8200])
    assert tengine.make_step(huge).route == tengine._Route(grid=True,
                                                           quad=False)
    spec = tspec.compile_spec(tbattle.get_config(24), [5, 5])
    assert tengine.make_step(spec).route == tengine._Route(grid=True,
                                                           quad=True)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**32 - 1])
def test_threefry_matches_jax(seed):
    """PRNGKey / split / fold_in / bits / uniform are bit-equal to
    jax.random's default key (exact: integer arithmetic, and uniform is a
    bit cast)."""
    assert jax.config.jax_threefry_partitionable
    jk = jax.random.PRNGKey(seed)
    tk = trandom.PRNGKey(seed)
    u32 = lambda a: np.asarray(a).astype(np.int64)  # noqa: E731
    np.testing.assert_array_equal(u32(jk), tk.numpy())
    np.testing.assert_array_equal(u32(jax.random.split(jk, 5)),
                                  trandom.split(tk, 5).numpy())
    np.testing.assert_array_equal(u32(jax.random.fold_in(jk, 7)),
                                  trandom.fold_in(tk, 7).numpy())
    np.testing.assert_array_equal(u32(jax.random.bits(jk, (3, 77))),
                                  trandom.bits(tk, (3, 77)).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, (1001,))),
                                  trandom.uniform(tk, (1001,)).numpy())
    # a batch of keys draws one stream per row, as vmap over single keys
    jkeys = jax.random.split(jk, 4)
    tkeys = torch.from_numpy(u32(jkeys))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (50,)))(jkeys)),
        trandom.uniform(tkeys, (50,)).numpy())
    np.testing.assert_array_equal(u32(jax.vmap(jax.random.split)(jkeys)),
                                  trandom.split(tkeys).numpy())
    np.testing.assert_array_equal(
        u32(jax.vmap(lambda k: jax.random.fold_in(k, 7))(jkeys)),
        trandom.fold_in(tkeys, 7).numpy())


def test_mul32_wraps_like_uint32():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    for c in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x632BE59B, 1, 0xFFFFFFFF):
        want = (a * np.uint32(c)).astype(np.int64)
        got = trandom.mul32(torch.from_numpy(a.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got, want)


def test_state_carry_over_round_trip():
    """A JAX State -> numpy -> port State -> numpy keeps every field, value
    and dtype."""
    jv = JVec(jbattle.get_config(16), [10, 10], n_envs=2)
    js = jax.jit(jv.reset)(jax.random.PRNGKey(0))
    arrays = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js)}
    assert set(arrays) == set(FIELDS)
    back = state_to_numpy(state_from_numpy(arrays, "cpu"))
    for name in FIELDS:
        assert back[name].dtype == arrays[name].dtype, name
        np.testing.assert_array_equal(back[name], arrays[name], err_msg=name)


def test_port_imports_without_jax():
    """The port and its entry points import no JAX and nothing of the JAX
    package."""
    code = (
        "import sys\n"
        "import magent_tpu_torch, magent_tpu_torch.parallel, "
        "magent_tpu_torch.ops, magent_tpu_torch.random\n"
        "import magent_tpu_torch.builtin.config.battle\n"
        "import magent_tpu_torch.core.engine, magent_tpu_torch.core.observe\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'magent_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_default_device_is_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VecGridWorld(tbattle.get_config(16), [5, 5], n_envs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
