"""Per-phase cost breakdown of the battle bench loop (battle 2x1000, B=16;
port of ``scripts/profile_phases.py``).

Times variants of ``tools.bench``'s loop, each a warm-up call and
``--calls`` timed calls of ``--steps`` steps from the same start, timed
with CUDA events (the JAX script scans each variant in one jitted
program).  A variant that leaves the state unchanged nudges ``hp`` by
1e-6 per step, as the JAX variants do, so that each step works on new
input.  The phase variants call the engine's internals as
``core.engine.make_step`` does: ``_attack_phase`` and ``_move_phase`` on
the route and tables of the venv's own step (the JAX script calls its
grid-path forms; both routes give the same state), the rule plans'
``apply``, ``observe.render_image`` on the packed grid.  Two variants
run only when named, as in the JAX script: ``one_group``, group 0's
observation alone (``venv.observe(state, 0)``, the JAX
``venv._observe1[0]``), and ``view_only``, each group rendered and
windowed by ``window_gather4`` (PERF.md §6 row 12) with no minimap,
liveness or features, at the positions and mask of
``observe.window_layout``, the observation's own; where a group's window
does not take ``window_gather4`` (battle's 13 x 13 x 7: ``vw * C`` past
65), it prints the JAX script's skip line.  The JAX script's
``BENCH_N_ENVS``, ``BENCH_STEPS`` and ``BENCH_CALLS`` are ``--n_envs``,
``--steps`` and ``--calls``.

    python -m magent_tpu_torch.tools.profile_phases [variant ...]
        [--device cpu]
    python -m magent_tpu_torch.tools.profile_phases one_group view_only
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import random as rnd
from ..builtin.config import battle
from ..core import engine, observe
from ..ops import window_gather as wg
from ..parallel import VecGridWorld, resolve_device
from ..parallel.vec_env import _wall_map
from . import bench
from .timing import elapsed_ms

N_PER_GROUP = 1000
MAP_SIZE = 200
VARIANTS = ("full", "obs_only", "step_only", "attack_only", "move_only",
            "grids_only", "render_only", "kernel_only", "rules_only")
OPT_IN = ("one_group", "view_only")  # run only when named
VIEW_SKIPPED = ("view_only: skipped (window_gather4 size constraints not "
                "met for this geometry)")


def obs_sink(venv, state, full=False):
    """One value of every agent's window (``full``: every value of it) and
    features, every group."""
    s = 0.0
    for view, feat in venv.observe_all(state):
        v = view.float().sum() if full else view[:, :, 0, 0, 0].sum()
        s = s + v + feat[:, 0, 0].sum()
    return s


def sink_state(st):
    return (st.hp[:, ::64].sum() + st.x[:, ::64].sum()
            + st.next_reward[:, ::64].sum())


def nudged(state):
    """The state with ``hp`` moved by 1e-6: the next step's input is new."""
    return state.replace(hp=state.hp + 1e-6)


def phase_context(venv, walls=None):
    """(route, tables) of ``venv``'s step, with the packed wall grid of
    interior ``walls`` on the gridless route, as ``make_step`` builds
    them."""
    spec, route = venv.spec, venv._step.route
    wall_ctx = None
    if not route.grid and walls is not None and len(walls):
        wall_ctx = engine._wall_rect_code(spec, _wall_map(spec, walls))
    return route, engine._tables_for(spec, {}, venv.device, wall_ctx)


def phase_body(venv, phase, ctx):
    """One engine phase (``attack``, ``move`` or ``rules``) on fresh random
    actions and ranks (``profile_phases.py:109-134``)."""
    spec = venv.spec
    route, T = ctx
    rules = spec.compiled_rules()
    B, A = venv.n_local, spec.n_agents_cap

    def body(venv, state, key):
        key, akey, rkey = rnd.split(key, 3).unbind(-2)
        st = state.replace(last_action=venv.random_actions(akey))
        rank = rnd.bits(rnd.split(rkey, B), (A,))
        seg_ctx = engine._seg_order(st) if route.seg else None
        if phase == "attack":
            st = engine._attack_phase(spec, T, st, rank, route, seg_ctx)
        elif phase == "move":
            st = engine._move_phase(spec, T, st, route, seg_ctx)
        else:
            nr, gr = st.next_reward, st.group_reward
            for rule in rules:
                nr, gr, _ = rule.apply(spec, st, nr, gr)
            st = st.replace(next_reward=nr, group_reward=gr)
        # keep positions/hp flowing without the full transition
        state = state.replace(hp=st.hp * 0.0 + state.hp,
                              next_reward=st.next_reward)
        return state, key, sink_state(st)

    return body


def view_windows(venv, layouts, state):
    """``view_only``'s work (``profile_phases.py:165-195``): each group's
    image rendered from one packed grid and windowed by ``window_gather4``
    at its ``observe.window_layout`` -> per group [B, cap, vh, vw*C]."""
    spec = venv.spec
    _, Wp, lanes = venv._grids.geometry[:3]
    g = venv._grids(state)
    return [wg.window_gather4(
        observe.render_image(spec, grp, g, lanes),
        lo["pos_fn"](state) * 1024, lo["mask"], vh=lo["vh"], vw=lo["vw"],
        C=spec.n_channel, Wp=Wp) for grp, lo in enumerate(layouts)]


def variant_bodies(venv, which, ctx):
    """{name: (venv, body)} of the variants in ``which``."""
    spec = venv.spec
    lanes = venv._grids.geometry[2] if venv._grids is not None else None

    def obs_only(venv, state, key):
        key, _ = rnd.split(key).unbind(-2)
        return nudged(state), key, obs_sink(venv, state)

    def step_only(venv, state, key):
        key, akey = rnd.split(key).unbind(-2)
        state, rewards, alive, done = venv.transition(
            state, venv.random_actions(akey))
        return state, key, rewards[:, 0].sum()

    def grids_only(venv, state, key):
        g = venv._grids(state)
        return nudged(state), key, g[:, ::32, ::32].float().sum()

    def render_only(venv, state, key):
        g = venv._grids(state)
        s = 0.0
        for grp in range(spec.n_groups):
            img = observe.render_image(spec, grp, g, lanes)
            s = s + img[:, ::32, ::128].sum()
        return nudged(state), key, s

    def kernel_only(venv, state, key):
        return nudged(state), key, obs_sink(venv, state)

    def one_group(venv, state, key):
        view, feat = venv.observe(state, 0)
        return (nudged(state), key,
                view[:, :, 0, 0, 0].sum() + feat[:, 0, 0].sum())

    def view_only(layouts):
        def body(venv, state, key):
            s = 0.0
            for view in view_windows(venv, layouts, state):
                s = s + view[:, :, 0, 0].sum()
            return nudged(state), key, s

        return body

    out = {}
    for name in which:
        if name == "full":
            out[name] = (venv, bench.body)
        elif name == "obs_only":
            out[name] = (venv, obs_only)
        elif name == "step_only":
            out[name] = (venv, step_only)
        elif name.endswith("_only") and name[:-5] in ("attack", "move",
                                                      "rules"):
            out[name] = (venv, phase_body(venv, name[:-5], ctx))
        elif name in ("grids_only", "render_only", "one_group",
                      "view_only") and lanes is None:
            print("%s: no grids_fn on this obs path" % name, flush=True)
        elif name == "grids_only":
            out[name] = (venv, grids_only)
        elif name == "render_only":
            out["grids+render"] = (venv, render_only)
        elif name == "one_group":
            out[name] = (venv, one_group)
        elif name == "view_only":
            layouts = [observe.window_layout(spec, grp, venv._grids.geometry,
                                             venv.device)
                       for grp in range(spec.n_groups)]
            if all(lo["replica_ok"] for lo in layouts):
                out[name] = (venv, view_only(layouts))
            else:
                print(VIEW_SKIPPED, flush=True)
        elif name == "kernel_only":
            # full observe minus minimap work: the spec with minimap off
            cfg2 = battle.get_config(MAP_SIZE)
            cfg2.set({"minimap_mode": False})
            venv2 = VecGridWorld(cfg2, [N_PER_GROUP, N_PER_GROUP],
                                 n_envs=venv.n_envs, device=venv.device)
            out["obs_nominimap"] = (venv2, kernel_only)
    return out


def timed(name, venv, body, state, key, steps, calls, agents):
    """A warm-up call and ``calls`` timed calls of ``steps`` steps of
    ``body`` from (``state``, ``key``) -> (ms per step, the last sink)."""
    print("[%s] running %s..." % (time.strftime("%H:%M:%S"), name),
          flush=True)
    sink = bench.run(venv, state, key, steps, body)[2]
    float(sink)
    out = [sink]

    def call():
        out[0] = bench.run(venv, state, key, steps, body)[2]

    ms = elapsed_ms(call, calls, venv.device) / (steps * calls)
    rate = agents * 1e3 / ms
    print("%-14s %7.3f ms/step   %7.2fM agent-steps/s"
          % (name, ms, rate / 1e6), flush=True)
    return ms, float(out[0])


def cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help="of %s (default: all but the last two)"
                    % " ".join(VARIANTS + OPT_IN))
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    return ap


def build(args, device):
    """The bench loop's ``VecGridWorld`` with ``args.n_envs`` envs."""
    return VecGridWorld(battle.get_config(MAP_SIZE),
                        [N_PER_GROUP, N_PER_GROUP], n_envs=args.n_envs,
                        device=device)


def main(argv=None):
    """-> {variant: (ms per step, sink)}."""
    ap = cli()
    args = ap.parse_args(argv)
    if set(args.variants) - set(VARIANTS + OPT_IN):
        ap.error("variants are %s" % " ".join(VARIANTS + OPT_IN))
    device = resolve_device(args.device)
    venv = build(args, device)
    agents = 2 * N_PER_GROUP * args.n_envs
    key = rnd.PRNGKey(1, device)
    results = {}
    with torch.no_grad():
        for name, (v, body) in variant_bodies(
                venv, args.variants, phase_context(venv)).items():
            state = v.reset(rnd.PRNGKey(0, device))
            results[name] = timed(name, v, body, state, key, args.steps,
                                  args.calls, agents)
    return results


if __name__ == "__main__":
    main()
