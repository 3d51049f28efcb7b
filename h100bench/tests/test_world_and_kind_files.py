"""What a world or a trainer brings as files alone (``layouts/``,
``kinds/``), on the CPU: battle's checked numbers pinned as they read
before the lookup, the pursuit layout against the program's, the tiny
pursuit cell on the routes its chip cell takes, the planted pursuit
faults, and the banded gather's roofline."""

import io
import json
import types

import numpy as np
import pytest
import torch

from h100bench import loops, run, world

from .tiny import entries, last_line


def fixed_window(calls_per_s):
    """A stand-in for ``run.run_window`` that runs ``seconds *
    calls_per_s`` calls (at least 3) and reports ``seconds``, so that the
    steps a run keeps for its check follow from the seed alone."""
    def run_window(loop, seconds, step_events=False):
        n = max(3, int(round(seconds * calls_per_s)))
        for _ in range(n):
            loop.call()
        loop.read_sink()
        return dict(seconds=seconds, calls=n, gaps_ms=[])
    return run_window


def run_fixed(monkeypatch, cell, seed, calls_per_s, seconds=0.3, **changes):
    """One tiny run of ``cell`` on the CPU with a fixed number of calls ->
    (result, standard error); ``changes`` update the traffic."""
    monkeypatch.setattr(run, "run_window", fixed_window(calls_per_s))
    ent = entries(cell)
    ent[2].update(changes)
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                                 trace=0, entries=ent)
    out, err = io.StringIO(), io.StringIO()
    result = run.run_cell(args, device=torch.device("cpu"), out=out, err=err)
    assert last_line(out.getvalue()) == json.loads(json.dumps(result))
    return result, err.getvalue()


# ------------------------------------------------------------------ battle
def three_calls(loop, seconds, step_events=False):
    """The window the battle readings below were pinned with: three calls,
    whatever ``seconds`` asks, reported as 0.5 s."""
    for _ in range(3):
        loop.call()
    loop.read_sink()
    return dict(seconds=0.5, calls=3, gaps_ms=[])


# each battle cell's checked numbers, keys and log on two seeds, read on
# the harness before its layouts and loops moved into files of their own
ENV = {"ints_differing": 0.0, "hp_gap": 0.0, "reward_gap": 0.0,
       "view_gap": 5.960464477539063e-08}
PINNED = {
    ("battle_dqn.env", 2**31 + 5): (ENV, 3, 384.0, "3 checked env steps"),
    ("battle_dqn.env", 3**20): (ENV, 3, 384.0, "3 checked env steps"),
    ("battle_dqn.train", 2**31 + 5): (
        {"ints_differing": 0.0, "hp_gap": 0.0, "reward_gap": 0.0,
         "greedy_gap": 0.0, "loss_gap": 1.2701022408111429e-06,
         "grad_gap": 3.8654284582635514e-07,
         "update_gap": 8.038788573476774e-06},
        12, 4608.0, "5 checked train steps"),
    ("battle_dqn.train", 3**20): (
        {"ints_differing": 0.0, "hp_gap": 0.0, "reward_gap": 0.0,
         "greedy_gap": 0.0, "loss_gap": 2.066663592504573e-06,
         "grad_gap": 4.5806205244474586e-07,
         "update_gap": 8.103158064050198e-06},
        12, 4608.0, "5 checked train steps"),
}


@pytest.mark.parametrize("cell,seed", list(PINNED))
def test_battle_reads_as_before_the_lookup(monkeypatch, cell, seed):
    checked, attempted, rate, log = PINNED[cell, seed]
    monkeypatch.setattr(run, "run_window", three_calls)
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=0.3,
                                 trace=0, entries=entries(cell))
    out, err = io.StringIO(), io.StringIO()
    r = run.run_cell(args, device=torch.device("cpu"), out=out, err=err)
    r = json.loads(json.dumps(r))
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checked"]
    rate_name = "%s_agent_steps_per_s" % cell.split(".")[1][:5].rstrip("_")
    assert {k: v["unit"] for k, v in r["metrics"].items()} == {
        rate_name: "agent-steps/s", "setup_s": "s"}
    assert r["metrics"][rate_name]["value"] == rate
    assert (r["correct"], r["attempted"], r["failed"]) == (True, attempted, 0)
    assert r["device"] == dict(platform="cpu", kind="cpu", count=1,
                               memory_peak_bytes=0)
    limits = run.load_json("limits", cell + ".json")
    assert r["checked"] == {k: dict(value=v, limit=limits[k])
                            for k, v in checked.items()}
    assert ("h100bench: %s seed %d: %s, " % (cell, seed, log)) in err.getvalue()


# ----------------------------------------------------------------- lookups
def test_layouts_and_kinds_are_files_found_by_name():
    kinds = sorted(p.stem for p in (run.HERE / "kinds").glob("*.py")
                   if p.stem != "__init__")
    assert kinds == ["dqn_train", "random_policy"]
    for kind in kinds:
        loop = loops.KINDS[kind]
        assert loop.__module__ == "h100bench.kinds." + kind
        for attr in ("rate", "window_steps", "unit", "steps_per_call",
                     "agents_per_profiled_step", "before_window",
                     "after_window", "context", "traced_context", "profile",
                     "judge", "calibrate"):
            assert hasattr(loop, attr), (kind, attr)
    with pytest.raises(ModuleNotFoundError):
        loops.KINDS["no_such_kind"]
    with pytest.raises(ModuleNotFoundError):
        world.layout({"placement": {"kind": "no_such_layout"}})
    for path in (run.HERE / "run.py", run.HERE / "world.py"):
        text = path.read_text()
        assert 'kind == "' not in text and "facing_squares(" not in text


def test_the_pursuit_layout_is_train_pursuits_at_map_1000():
    """12,500 predators and 25,000 prey on free cells, 30,000 interior
    walls, as the program's ``pursuit.layout`` draws them from seed 11."""
    from magent_tpu_torch.builtin.config import pursuit

    w = run.load_json("configs", "pursuit.json")["world"]
    wall, (pred, prey) = world.layout(w)
    assert len(pred) == 12500 and len(prey) == 25000
    assert wall.sum() == 4 * 999 + 30000
    (p_pred, p_prey), p_walls = pursuit.layout(1000, 11, 0.03)
    assert (pred == np.array(p_pred)[:, :2]).all()
    assert (prey == np.array(p_prey)[:, :2]).all()
    inner = world.interior_walls(wall)
    assert sorted(map(tuple, inner.tolist())) == sorted(map(tuple, p_walls))
    cells = np.zeros((1000, 1000), np.int64)  # every body on free cells
    for x, y in pred.tolist():
        cells[y:y + 2, x:x + 2] += 1
    cells[prey[:, 1], prey[:, 0]] += 1
    assert cells.max() == 1 and not (cells.astype(bool) & wall).any()


# ---------------------------------------------------------- tiny pursuit
@pytest.fixture
def chip_routes(monkeypatch):
    """The routes ``pursuit.env`` takes on the card (37,500 agents a world,
    48 worlds): the grid path with the sort branches, and the banded
    window gather; forced at the tiny size."""
    from magent_tpu_torch.core import observe
    from magent_tpu_torch.ops import attack_prefix as ap

    monkeypatch.setattr(ap, "QUAD_MAX_AGENTS", 0)
    monkeypatch.setattr(observe, "VMEM_IMAGE_BUDGET", 1)
    made = []
    make = loops.make_venv

    def recorded(*a, **k):
        made.append(make(*a, **k))
        return made[-1]
    monkeypatch.setattr(loops, "make_venv", recorded)
    return made


TINY = dict(calls_per_s=100, seconds=0.4, checked_steps=24)


def test_tiny_pursuit_on_the_chip_cells_routes_is_correct(monkeypatch,
                                                          chip_routes):
    """Map 24 (7 predators, 14 prey, 17 interior walls), B=2."""
    ent = entries("pursuit.env")
    assert [g["n"] for g in ent[1]["world"]["groups"]] == [7, 14]
    assert ent[1]["n_envs"] == 2
    for seed in (2**31 + 5, 2**33 + 7):
        result, err = run_fixed(monkeypatch, "pursuit.env", seed, **TINY)
        assert result["correct"] is True, err[-2000:]
        assert "24 checked env steps" in err
    venv = chip_routes[-1]
    assert venv._step.route.grid and not venv._step.route.quad
    assert all(o.route == "window_gather_banded" for o in venv._observe)
    assert int(venv._wall[1:-1, 1:-1].sum()) == 17


def _break_pursuit(monkeypatch, fault):
    """Plant ``fault`` in the program (or in what the harness hands it)."""
    from magent_tpu_torch import config, spec
    from magent_tpu_torch.core import engine

    if fault == "move_blocked_by_top_left_only":
        def top_left(spec_, T, enc, is_move, in_bounds, nx, ny, bw, bh):
            body, cell, claim_cell = engine._rect_cells(spec_, T, nx, ny,
                                                        bw, bh)
            first = torch.zeros_like(body)
            first[0] = body[0]
            e = engine._from_cells(engine._grid_at(enc, cell), body.shape[0])
            hit = is_move & first & (e != -1) & (e != T.slots)
            blank = is_move & in_bounds & ~hit.any(0)
            collide_obj = engine._first_along(hit & in_bounds & (e >= 0), e,
                                              -1)
            wins, lost, winner = engine._claim_rects(spec_, T, blank, body,
                                                     claim_cell)
            return blank, collide_obj, wins, engine._first_along(lost,
                                                                 winner, -1)
        monkeypatch.setattr(engine, "_rect_moves_on_grid", top_left)
    elif fault == "interior_walls_left_out":
        monkeypatch.setattr(world, "interior_walls",
                            lambda wall: np.zeros((0, 2), np.int64))
    elif fault == "prey_penalty_dropped":
        add = config.Config.add_reward_rule

        def dropped(self, on, receiver, value):
            return add(self, on, receiver=receiver[:1], value=value[:1])
        monkeypatch.setattr(config.Config, "add_reward_rule", dropped)
    elif fault == "attack_from_top_left":
        init = spec.AgentTypeSpec.__init__

        def corner(self, *a, **k):
            init(self, *a, **k)
            self.att_x_offset = self.att_y_offset = 0
        monkeypatch.setattr(spec.AgentTypeSpec, "__init__", corner)


@pytest.mark.parametrize("fault", ["move_blocked_by_top_left_only",
                                   "interior_walls_left_out",
                                   "prey_penalty_dropped",
                                   "attack_from_top_left",
                                   "env_state_unchanged", "half_envs",
                                   "reward_altered"])
def test_a_planted_pursuit_fault_is_not_correct(monkeypatch, chip_routes,
                                                fault):
    """Pursuit's own faults, and the env cells' faults of the harness's
    tests (a step that returns its state, half of the envs left out, a
    reward altered where it is produced)."""
    if fault in ("env_state_unchanged", "half_envs", "reward_altered"):
        from .test_h100bench_harness import _break

        _break(monkeypatch, fault)
    else:
        _break_pursuit(monkeypatch, fault)
    result, err = run_fixed(monkeypatch, "pursuit.env", 2**31 + 5, **TINY)
    assert result["correct"] is False
    assert "FAILED" in err


# --------------------------------------------------------------- roofline
def test_the_banded_roofline_on_hand_worked_shapes():
    """Two envs of a 6 x 8 image (C=2, Wp=4), 2 x 2 windows with one
    masked-out value: env 0's windows at cells 0 and 5 share one value,
    env 1's leaves the image on the right (nothing read) and one at a
    negative position."""
    wgb = run.load_module("rooflines", "window_gather_banded")
    gfull = torch.zeros((2, 6, 8))
    mask = torch.ones((2, 4))
    mask[1, 3] = 0.0
    pos = torch.tensor([[0, 5], [3, -1]], dtype=torch.int32)
    out = torch.zeros((2, 2, 2, 4))
    assert wgb.image_values_read(gfull, pos, mask, C=2, Wp=4) == 7 + 7 - 1
    act = torch.ones((2, 2), dtype=torch.int32)
    w = wgb.work((gfull, pos, mask), dict(C=2, Wp=4, act=act), out)
    assert w == dict(bytes=13 * 4 + 32 * 4 + 4 * 4 + 8 * 4 + 4 * 4,
                     f32=2 * 32)
    rows = torch.tensor([[20, 20]], dtype=torch.int32)  # rows 5 and 6
    assert wgb.image_values_read(gfull[:1], rows, mask, C=2, Wp=4) == 4
