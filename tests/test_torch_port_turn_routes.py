"""The port's turn-mode observation against the JAX package's, on the CPU
(the kernel routes on a stepped world: ``test_torch_port_turn_observe.py``):

- the per-direction route (both budgets shrunk) against JAX
  ``_make_observe_rotating_xla``, exactly; the stacked route against it
  within the JAX package's tolerance between the two (atol 1e-6: the
  stacked route quantizes the hp to 2**-23 of its maximum);
- each facing alone, every body turned in place: the stacked route
  against the JAX kernel route in interpret mode, the per-direction route
  against the JAX gather, exactly;
- food cells with turn mode, on both;
- the routes the frame sizes pick: ``bench_pursuit --turn``'s map 64 (the
  stacked route) and map 1000 (the banded route, a [1, 4 * 1048, 5380]
  image), and the per-direction route past the band budget."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.core import observe as jobserve

from magent_tpu_torch import gridworld as tgw
from magent_tpu_torch import spec as tspec
from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.core.state import state_from_numpy

from test_torch_port_turn import ROUTE_ATOL, batched, jax_turn_world
from test_torch_port_turn_observe import CAPS, DTYPES, _assert_exact, _world


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("minimap", [False, True], ids=["plain", "minimap"])
@pytest.mark.parametrize("group", [0, 1])
def test_per_direction_route_matches_jax_xla(group, minimap, dtype,
                                             monkeypatch):
    """Exact against the JAX per-direction gather; the stacked route within
    ROUTE_ATOL of it, its features exact."""
    jspec, js, sp, ts = _world(minimap)
    tdt, jdt = DTYPES[dtype]
    want = jax.jit(jobserve._make_observe_rotating_xla(
        jspec, group, obs_dtype=jdt))(js)
    stacked = tobserve.make_observe(sp, group, tdt)(ts)
    monkeypatch.setattr(tobserve, "VMEM_IMAGE_BUDGET", 0)
    monkeypatch.setattr(tobserve, "_BAND_BUDGET", 0)
    tobs = tobserve.make_observe(sp, group, tdt)
    assert tobs.route == "per_direction"
    _assert_exact(tobs(ts), want, "per-direction group %d" % group)
    np.testing.assert_allclose(stacked[0][0].float().numpy(),
                               np.asarray(want[0], np.float32),
                               atol=ROUTE_ATOL if dtype == "f32" else 2**-8,
                               rtol=0)
    np.testing.assert_array_equal(stacked[1][0].numpy(), np.asarray(want[1]))


def _turned(js, d):
    """``js`` with every body turned in place to facing ``d`` (the cells
    of ``test_torch_port_turn.PLACEMENTS`` stay disjoint in every facing)
    and the occupancy grid rebuilt."""
    arrays = {k: np.asarray(v).copy() for k, v in batched(js).items()}
    A = arrays["x"].shape[1]
    arrays["dir"][:] = d
    w, l = np.asarray([1] * CAPS + [1] * CAPS), np.asarray([2] * CAPS
                                                           + [1] * CAPS)
    bw, bh = (w, l) if d in (1, 3) else (l, w)
    grid = np.full(arrays["cell_slot"].shape[1:], -1, np.int32)
    for s in range(A):
        if arrays["active"][0, s]:
            x, y = arrays["x"][0, s], arrays["y"][0, s]
            assert (grid[y:y + bh[s], x:x + bw[s]] == -1).all()
            grid[y:y + bh[s], x:x + bw[s]] = s
    arrays["cell_slot"][0] = grid
    return arrays


@functools.lru_cache(maxsize=None)
def _jax_fns(group):
    """The JAX stacked kernel route and per-direction gather of the
    unstepped world's spec, each jitted once."""
    env, sp = jax_turn_world(caps=CAPS, seed=6)
    return (env, sp,
            jax.jit(jobserve._make_observe_rotating(env.spec, group,
                                                    interpret=True)),
            jax.jit(jobserve._make_observe_rotating_xla(env.spec, group)))


@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("d", [0, 1, 2, 3], ids=["east", "south", "west",
                                                  "north"])
def test_each_facing_alone(d, group, monkeypatch):
    """All agents facing ``d``: the stacked route exactly equal to the JAX
    kernel route (each window's origin in band d), the per-direction route
    exactly equal to the JAX gather."""
    env, sp, jkernel, jxla = _jax_fns(group)
    arrays = _turned(env.state, d)
    js = type(env.state)(**{k: jnp.asarray(v[0]) for k, v in arrays.items()})
    ts = state_from_numpy(arrays, "cpu")
    tag = "facing %d group %d" % (d, group)
    _assert_exact(tobserve.make_observe(sp, group)(ts), jkernel(js), tag)
    monkeypatch.setattr(tobserve, "VMEM_IMAGE_BUDGET", 0)
    monkeypatch.setattr(tobserve, "_BAND_BUDGET", 0)
    _assert_exact(tobserve.make_observe(sp, group)(ts), jxla(js), tag)


def test_food_cells_with_turn_mode():
    """Turn mode with food: corpse food renders at code 1 in every band
    (stacked route against the JAX kernel route, per-direction route
    against the JAX gather, both exact)."""
    jspec, js, sp, ts = _world(False, food=True)
    assert (ts.cell_food >= 0).any()
    for group in (0, 1):
        want = jax.jit(jobserve._make_observe_rotating(
            jspec, group, interpret=True))(js)
        _assert_exact(tobserve.make_observe(sp, group)(ts), want,
                      "food group %d" % group)
        want = jax.jit(jobserve._make_observe_rotating_xla(jspec, group))(js)
        _assert_exact(tobserve._make_observe_dirs(sp, group,
                                                  torch.float32)(ts),
                      want, "food per-direction group %d" % group)


def _pursuit_turn_spec(map_size):
    """``scripts/bench_pursuit.py --turn``'s config at ``map_size`` with its
    caps (1.25% and 2.5% of the cells)."""
    cfg = tgw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size,
             "turn_mode": True})
    pred = cfg.register_agent_type(
        "predator", {'width': 2, 'length': 2, 'hp': 1, 'speed': 1,
                     'view_range': tgw.CircleRange(5),
                     'attack_range': tgw.CircleRange(2),
                     'attack_penalty': -0.2})
    prey = cfg.register_agent_type(
        "prey", {'width': 1, 'length': 1, 'hp': 1, 'speed': 1.5,
                 'view_range': tgw.CircleRange(4),
                 'attack_range': tgw.CircleRange(0)})
    cfg.add_group(pred)
    cfg.add_group(prey)
    n = map_size * map_size
    return tspec.compile_spec(cfg, [int(n * 0.0125), int(n * 0.025)])


def test_routes_by_frame_size(monkeypatch):
    """bench_pursuit --turn: map 64 takes the stacked route, map 1000 the
    banded one, each group on a stacked image of its own geometry; a band
    past ``_BAND_BUDGET`` takes the per-direction route."""
    small, big = _pursuit_turn_spec(64), _pursuit_turn_spec(1000)
    want = {64: ("window_gather", [(112, 154, 770), (104, 154, 770)]),
            1000: ("window_gather_banded", [(1048, 1076, 5380),
                                            (1040, 1076, 5380)])}
    for m, sp in ((64, small), (1000, big)):
        route, geoms = want[m]
        obs = [tobserve.make_observe(sp, g) for g in range(2)]
        assert [o.route for o in obs] == [route] * 2
        assert [o.geometry[:3] for o in obs] == geoms
    monkeypatch.setattr(tobserve, "_BAND_BUDGET", 56 * 5380 * 4 - 1)
    assert [tobserve.make_observe(big, g).route for g in range(2)] == [
        "per_direction", "window_gather_banded"]
