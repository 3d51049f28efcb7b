"""Randomized differential fuzz over RANDOM configs (port of
``scripts/test/fuzz_reference.py``): the port's sequential engine
(``GridWorld(cfg, engine_mode="sequential", device=...)``) against a
baseline leg, beyond the 14 fixed golden scenarios.

Each seed draws a config (agent-type attributes, modes, reward rules,
walls, populations) with the JAX script's ``random_config``, drives BOTH
legs with the identical seeded action stream, and compares the full
getter surface every step (num / ids / pos / alive / rewards bit-wise,
hp-dependent rewards to 1e-5) plus the first step's observations.  Each
leg runs in its own child process (``--child``), which writes its trace
to an npz file.

Legs: ``port``, the port's engine on ``--device``, against ``--against
ref``, the reference C++ build (``<--reference>/python``, built with
cmake; kept for a machine that has one), or ``--against cpu``,
the port's engine on the CPU (the card's leg against the host's).

    OMP_NUM_THREADS=1 python -m magent_tpu_torch.tools.fuzz_reference
        [--seeds 25] [--start 0] [--steps 8] [--against cpu]
        [--device cpu]

The reference attack loop is an OpenMP merge reduction; OMP_NUM_THREADS=1
makes its event order deterministic (same requirement as
tests/golden/generate_golden.py).
"""

import argparse
import os
import random
import subprocess
import sys
import tempfile

import numpy as np

from ..parallel import resolve_device


def random_config(gw, rng):
    """Draw a reference-legal 2-group config with random attributes, modes
    and reward rules (attribute ranges follow the builtin configs)."""
    map_size = rng.choice([20, 28, 36, 48])
    cfg = gw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size})
    cfg.set({"embedding_size": rng.choice([0, 4, 10])})
    if rng.random() < 0.35:
        cfg.set({"minimap_mode": True})
    if rng.random() < 0.35:
        cfg.set({"food_mode": True})
    turn = rng.random() < 0.25
    if turn:
        cfg.set({"turn_mode": True})

    def rand_type(name):
        w = rng.choice([1, 1, 1, 2]) if turn else 1
        attrs = {
            "width": w, "length": w,
            "hp": rng.choice([3, 5, 10, 15]),
            "speed": rng.choice([1, 1, 2, 3]),
            "view_range": gw.CircleRange(rng.choice([1, 2, 4, 6])),
            "attack_range": gw.CircleRange(rng.choice([0, 1, 1, 1.5, 2])),
            "damage": rng.choice([0, 1, 2, 4]),
            "step_recover": rng.choice([-0.5, -0.1, 0, 0.1, 0.2]),
            "step_reward": rng.choice([0, -0.01, 1]),
            "kill_reward": rng.choice([0, 5, 100]),
            "dead_penalty": rng.choice([0, -0.1, -1]),
            "attack_penalty": rng.choice([0, -0.1]),
            "kill_supply": rng.choice([0, 0, 8]),
            "attack_in_group": rng.random() < 0.25,
        }
        return cfg.register_agent_type(name, attrs)

    g0 = cfg.add_group(rand_type("t0"))
    g1 = cfg.add_group(rand_type("t1"))
    if rng.random() < 0.25:  # third group (train_multi-style worlds)
        g2 = cfg.add_group(rand_type("t2"))
        c = gw.AgentSymbol(g2, index="any")
        cfg.add_reward_rule(gw.Event(c, "attack", gw.AgentSymbol(g0, "any")),
                            receiver=c, value=0.3)
    a = gw.AgentSymbol(g0, index="any")
    b = gw.AgentSymbol(g1, index="any")
    for sub, obj in ((a, b), (b, a)):
        if rng.random() < 0.8:
            cfg.add_reward_rule(gw.Event(sub, "attack", obj), receiver=sub,
                                value=round(rng.uniform(0.1, 1), 2))
        if rng.random() < 0.4:
            cfg.add_reward_rule(gw.Event(sub, "kill", obj), receiver=sub,
                                value=rng.choice([1, 4]))
        if rng.random() < 0.25:
            cfg.add_reward_rule(gw.Event(sub, "collide", obj), receiver=sub,
                                value=-0.3)
        if rng.random() < 0.25:
            cfg.add_reward_rule(gw.Event(sub, "die"), receiver=sub,
                                value=-2.0)
    if rng.random() < 0.3:
        # conjunctive pair rule (double_attack shape)
        a2 = gw.AgentSymbol(g0, index="any")
        e1 = gw.Event(a, "attack", b)
        e2 = gw.Event(a2, "attack", b)
        cfg.add_reward_rule(e1 & e2, receiver=[a, a2], value=[1, 1])
    if rng.random() < 0.3:
        half = map_size // 2
        cfg.add_reward_rule(
            gw.Event(a, "in", ((1, 1), (half, half))), receiver=a, value=0.5)
    return cfg, map_size


def drive(magent_module, make_config, seed, steps, record_views,
          render_dir=None, all_views=False):
    """Build + drive one engine; returns the per-step getter trace."""
    gw = magent_module.gridworld
    rng = random.Random(seed)
    cfg, map_size = make_config(gw, rng)
    env = magent_module.GridWorld(cfg)
    handles = env.get_handles()
    if render_dir:
        env.set_render_dir(render_dir)
    env.reset()
    n_walls = rng.choice([0, 0, 8, 20])
    if n_walls:
        env.add_walls(method="random", n=n_walls)
    for k, h in enumerate(handles):
        if rng.random() < 0.2:
            # fill placement (train_battle generate_map idiom)
            side = rng.randrange(3, 6)
            x0 = rng.randrange(1, map_size - 2 * side)
            y0 = rng.randrange(1, map_size - 2 * side)
            env.add_agents(h, method="fill", pos=[x0, y0],
                           size=[side, side])
        else:
            env.add_agents(h, method="random", n=rng.randrange(8, 30))

    trace = []
    arng = np.random.RandomState(10_000 + seed)
    done = False
    for step in range(steps):
        if done:
            break
        rec = {}
        for i, h in enumerate(handles):
            view, feat = env.get_observation(h)
            if record_views and (step == 0 or all_views):
                rec["view0_%d" % i] = np.array(view, np.float32, copy=True)
                rec["feat0_%d" % i] = np.array(feat, np.float32, copy=True)
            n = env.get_num(h)
            acts = arng.randint(0, env.get_action_space(h)[0], n).astype(np.int32)
            env.set_action(h, acts)
        done = bool(env.step())
        for i, h in enumerate(handles):
            rec["num_%d" % i] = env.get_num(h)
            rec["ids_%d" % i] = np.asarray(env.get_agent_id(h), np.int32).copy()
            rec["pos_%d" % i] = np.asarray(env.get_pos(h), np.int32).copy()
            rec["rew_%d" % i] = np.asarray(env.get_reward(h), np.float32).copy()
            rec["alive_%d" % i] = np.asarray(env.get_alive(h), bool).copy()
            rec["mean_%d" % i] = np.asarray(
                env.get_mean_info(h), np.float32).copy()
        rec["gmm"] = np.asarray(
            env.get_global_minimap(8, 8), np.float32).copy()
        rec["done"] = done
        trace.append(rec)
        if render_dir:
            env.render()
        env.clear_dead()
    return trace


def compare(seed, ref_trace, our_trace):
    assert len(ref_trace) == len(our_trace), (
        "seed %d: episode length %d vs %d"
        % (seed, len(ref_trace), len(our_trace)))
    for step, (r, o) in enumerate(zip(ref_trace, our_trace)):
        assert set(r) == set(o), (seed, step, set(r) ^ set(o))
        for key, rv in r.items():
            ov = o[key]
            where = "seed %d step %d %s" % (seed, step, key)
            if key.startswith(("rew", "view0", "feat0", "mean", "gmm")):
                np.testing.assert_allclose(ov, rv, atol=1e-5, err_msg=where)
            elif key.startswith(("num", "done")):
                assert ov == rv, "%s: %s vs %s" % (where, ov, rv)
            else:
                np.testing.assert_array_equal(ov, rv, err_msg=where)


def _trace_to_flat(trace):
    flat = {"n_steps": np.asarray(len(trace))}
    for step, rec in enumerate(trace):
        for key, val in rec.items():
            flat["s%d/%s" % (step, key)] = np.asarray(val)
    return flat


def _flat_to_trace(flat):
    n = int(flat["n_steps"])
    trace = [{} for _ in range(n)]
    for key, val in flat.items():
        if key == "n_steps":
            continue
        step, name = key.split("/", 1)
        v = val
        if name.startswith(("num", "done")):
            v = val.item()
        trace[int(step[1:])][name] = v
    return trace


def child_main(args):
    os.environ["OMP_NUM_THREADS"] = "1"
    if args.child == "ref":
        sys.path.insert(0, os.path.join(args.reference, "python"))
        import magent as mod
    else:
        import magent_tpu_torch

        class mod:
            """magent_tpu_torch facade pinning engine_mode='sequential' on
            the leg's device."""
            gridworld = magent_tpu_torch.gridworld

            @staticmethod
            def GridWorld(cfg, **kw):
                return magent_tpu_torch.GridWorld(
                    cfg, engine_mode="sequential", device=args.device, **kw)

    trace = drive(mod, random_config, args.seed, args.steps, args.views,
                  render_dir=args.render_dir, all_views=args.all_views)
    np.savez_compressed(args.out, **_trace_to_flat(trace))


def cli():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reference", default="/tmp/refbuild")
    parser.add_argument("--against", choices=["ref", "cpu"], default="ref",
                        help="the baseline leg: the C++ build or the port "
                             "on the CPU")
    parser.add_argument("--seeds", type=int, default=25)
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--views", action="store_true",
                        help="also compare first-step observations")
    parser.add_argument("--all-views", action="store_true",
                        help="compare observations EVERY step (slow; "
                             "exercises hp/death/food channel updates)")
    parser.add_argument("--render", action="store_true",
                        help="also dump + byte-compare the replay files")
    parser.add_argument("--child", choices=["ref", "port"],
                        help="internal: produce one leg's trace")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--out")
    parser.add_argument("--render-dir")
    parser.add_argument("--device", default=None,
                        help="the port leg's device; default: the card "
                             "(raises without one)")
    return parser


def child_command(leg, device, seed, out, args, render_dir=None):
    """The command of one leg's child process."""
    cmd = [sys.executable, "-m", "magent_tpu_torch.tools.fuzz_reference",
           "--child", leg, "--seed", str(seed), "--steps", str(args.steps),
           "--out", out, "--reference", args.reference, "--device", device]
    if args.views:
        cmd.append("--views")
    if args.all_views:
        cmd += ["--views", "--all-views"]
    if render_dir:
        cmd += ["--render-dir", render_dir]
    return cmd


def main(argv=None):
    """-> the number of failed seeds."""
    args = cli().parse_args(argv)
    if args.child:
        child_main(args)
        return 0
    device = str(resolve_device(args.device))
    # the baseline leg first, then the port on its device
    legs = [("ref", "ref", "cpu") if args.against == "ref"
            else ("cpu", "port", "cpu"), ("port", "port", device)]
    base = legs[0][0]
    # each leg runs in its own subprocess: some random configs SEGFAULT
    # the reference C++ engine (e.g. seed 937: turn_mode 2x2 bodies) — a
    # reference crash is recorded, compare skipped, and the port is still
    # required to complete the episode without crashing
    failures = ref_crashes = 0
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for seed in range(args.start, args.start + args.seeds):
        with tempfile.TemporaryDirectory() as td:
            traces = {}
            crashed = False
            for name, leg, dev in legs:
                out = os.path.join(td, name + ".npz")
                rdir = None
                if args.render:
                    rdir = os.path.join(td, name + "_render")
                    os.makedirs(rdir, exist_ok=True)
                proc = subprocess.run(
                    child_command(leg, dev, seed, out, args, rdir),
                    capture_output=True, text=True, timeout=900, env=env)
                if proc.returncode != 0:
                    if name == "ref":
                        ref_crashes += 1
                        crashed = True
                        print("seed %d: REFERENCE crashed (rc %d) — compare "
                              "skipped" % (seed, proc.returncode), flush=True)
                        continue
                    failures += 1
                    print("seed %d: the %s leg failed (rc %d):\n%s" % (
                        seed, name, proc.returncode, proc.stderr[-1500:]),
                        flush=True)
                    break
                traces[name] = _flat_to_trace(dict(np.load(out)))
            render_ok = True
            if args.render and len(traces) == 2 and not crashed:
                # the first episode dumps video_1.txt (reset bumps the
                # file counter before the first frame, GridWorld.cc:97)
                for fn in ("config.json", "video_1.txt"):
                    pa = os.path.join(td, base + "_render", fn)
                    pb = os.path.join(td, "port_render", fn)
                    da = open(pa, "rb").read() if os.path.exists(pa) else None
                    db = open(pb, "rb").read() if os.path.exists(pb) else None
                    if da is None or da != db:
                        render_ok = False
                        failures += 1
                        print("seed %d FAILED: replay %s bytes differ"
                              % (seed, fn), flush=True)
                        break
        if "port" not in traces or (crashed and "port" in traces):
            continue
        if args.render and not render_ok:
            continue
        try:
            compare(seed, traces[base], traces["port"])
            print("seed %d ok (%d steps)" % (seed, len(traces[base])),
                  flush=True)
        except AssertionError as e:
            failures += 1
            print("seed %d FAILED: %s" % (seed, str(e)[:500]), flush=True)
    print("done: %d/%d seeds passed (%d reference crashes skipped)"
          % (args.seeds - failures, args.seeds, ref_crashes))
    return failures


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
