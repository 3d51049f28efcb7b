"""Randomized DiscreteSnake differential fuzz over random scenario
parameters (port of ``scripts/test/fuzz_snake.py``): the port's sequential
snake (``DiscreteSnake(cfg, engine_mode="sequential")``) against a
baseline leg, beyond the one fixed snake golden.

The sequential snake consumes the PER-PROCESS glibc random() stream from
its startup state (reference DiscreteSnake.cc:84,111 uses
random()/srand), so every trace is produced in a FRESH child process
(``--child``), which writes it to an npz file; the legs are compared
field by field.  Legs: ``port`` against ``--against ref``, the reference
C++ build (``<--reference>/python``; kept for a machine that has one), or
``--against cpu``, a second port leg.  The sequential snake is a host
engine that takes no device: ``--device`` is resolved (the card by
default, raising without one) and handed to each port leg, which runs on
the host all the same.

    python -m magent_tpu_torch.tools.fuzz_snake [--seeds 10] [--start 0]
        [--against cpu] [--device cpu]
"""

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile

import numpy as np

from ..parallel import resolve_device


def random_spec(seed):
    rng = random.Random(seed)
    m = rng.choice([16, 24, 32])
    v = rng.choice([7, 11, 15])
    return dict(
        map_width=m, map_height=m, view_width=v, view_height=v,
        total_resource=rng.choice([20, 40, 80]),
        n_food=rng.randrange(5, 30),
        n_agents=rng.randrange(2, 9),
        steps=rng.randrange(8, 30),
        action_seed=1000 + seed,
    )


# the scenario runner of the repository's golden tests
# (tests/golden/scenarios.py), kept here so that the package stands alone
def run_snake_spec(magent_module, spec, engine_mode=None, render_dir=None):
    import importlib
    ds = importlib.import_module(magent_module.__name__ + ".discrete_snake")
    conf = {"map_width": spec["map_width"], "map_height": spec["map_height"],
            "view_width": spec["view_width"], "view_height": spec["view_height"],
            "total_resource": spec["total_resource"]}
    if hasattr(ds, "_LIB"):
        # the reference wrapper passes config keys as str to ctypes, which
        # truncates them under Python 3 (discrete_snake.py:41-47); build the
        # env with an empty config and push properly-encoded keys ourselves
        import ctypes

        cfg = ds.Config()
        env = ds.DiscreteSnake(cfg)
        for key, value in conf.items():
            ds._LIB.env_config_game(
                env.game, ctypes.c_char_p(key.encode("ascii")),
                ctypes.byref(ctypes.c_int(int(value))))
        import numpy as _np
        buf = _np.empty((3,), dtype=_np.int32)
        ds._LIB.env_get_info(env.game, 0, b"view_space",
                             buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        env.view_space = [int(buf[0]), int(buf[1]), int(buf[2])]
        ds._LIB.env_get_info(env.game, 0, b"feature_space",
                             buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        env.feature_space = int(buf[0])

        # two more Python-3 breakages in the reference wrapper: get_num /
        # get_food_num pass the info name as str (truncated by ctypes) and
        # get_alive allocates with the removed np.bool alias
        import types

        def _get_num(self, handle=0):
            num = ctypes.c_int32()
            ds._LIB.env_get_info(self.game, handle, b"num", ctypes.byref(num))
            return num.value

        def _get_food_num(self):
            num = ctypes.c_int32()
            ds._LIB.env_get_info(self.game, -2, b"num", ctypes.byref(num))
            return num.value

        def _get_alive(self, handle=0):
            n = self.get_num(handle)
            abuf = _np.empty((n,), dtype=_np.bool_)
            ds._LIB.env_get_info(self.game, handle, b"alive",
                                 abuf.ctypes.data_as(ctypes.POINTER(ctypes.c_bool)))
            return abuf

        env.get_num = types.MethodType(_get_num, env)
        env.get_food_num = types.MethodType(_get_food_num, env)
        env.get_alive = types.MethodType(_get_alive, env)
        if render_dir is not None:
            # the wrapper's set_render_dir passes a str to ctypes
            # (truncated under Python 3) — push the encoded key directly
            _LIB = ds._LIB
            _LIB.env_config_game(
                env.game, ctypes.c_char_p(b"render_dir"),
                ctypes.c_char_p(render_dir.encode("ascii")))
    else:
        cfg = ds.Config()
        cfg.set(conf)
        kwargs = {}
        if engine_mode is not None:
            kwargs["engine_mode"] = engine_mode
        env = ds.DiscreteSnake(cfg, **kwargs)
        if render_dir is not None:
            env.set_render_dir(render_dir)
    env.reset()
    env.add_food(method="random", n=spec["n_food"])
    env.add_agent(method="random", n=spec["n_agents"])

    trace = {"steps": 0, "num": [], "food_num": [], "ids": [], "head": [],
             "length": [], "alive": [], "rew": [], "view0": None,
             "feat0": None}
    rng = np.random.RandomState(spec["action_seed"])
    for step in range(spec["steps"]):
        view, feat = env.get_observation(0)
        if step == 0:
            trace["view0"] = np.array(view, np.float32, copy=True)
            trace["feat0"] = np.array(feat, np.float32, copy=True)
        n = env.get_num()
        acts = rng.randint(0, 5, n).astype(np.int32)
        env.set_action(0, acts)
        env.step()
        trace["num"].append(env.get_num())
        trace["food_num"].append(env.get_food_num())
        trace["ids"].append(np.asarray(env.get_agent_id(), np.int32))
        trace["head"].append(np.asarray(env.get_head(), np.int32))
        trace["length"].append(np.asarray(env.get_length(), np.int32))
        trace["alive"].append(np.asarray(env.get_alive(), bool))
        trace["rew"].append(np.asarray(env.get_reward(), np.float32))
        if render_dir is not None:
            env.render()
        env.clear_dead()
        trace["steps"] = step + 1
    return trace


def flatten_snake_trace(trace):
    flat = {"steps": trace["steps"], "num": np.asarray(trace["num"]),
            "food_num": np.asarray(trace["food_num"]),
            "view0": trace["view0"], "feat0": trace["feat0"]}
    for key in ("ids", "head", "length", "alive", "rew"):
        flat[key + "_data"] = np.concatenate(
            [np.asarray(v).reshape(len(v), -1).reshape(-1)
             if np.asarray(v).size else np.asarray(v, np.float32).reshape(-1)
             for v in trace[key]]
        ) if trace[key] else np.zeros(0)
    return flat


def child(engine, spec, out, reference, render_dir=None):
    if engine == "ref":
        os.environ["OMP_NUM_THREADS"] = "1"
        sys.path.insert(0, os.path.join(reference, "python"))
        import magent as mod
    else:
        import magent_tpu_torch as mod
    mode = "sequential" if engine == "port" else None
    trace = run_snake_spec(mod, spec, engine_mode=mode,
                           render_dir=render_dir)
    np.savez_compressed(out, **flatten_snake_trace(trace))


def compare_replays(ref_dir, tpu_dir):
    """Structural replay comparison.  The reference's food block iterates a
    std::set<Food*> keyed by HEAP ADDRESSES (RenderGenerator.cc:175), so
    its order is not reproducible even across its own runs: food lines
    compare as multisets of (x, y); snake segments compare as the exact
    sequence; static.map compares as a wall set."""
    def walls(path):
        lines = open(path).read().split()
        return sorted(zip(lines[1::2], lines[2::2]))

    wa = os.path.join(ref_dir, "static.map")
    wb = os.path.join(tpu_dir, "static.map")
    if not (os.path.exists(wa) and os.path.exists(wb)):
        return "static.map missing (%s %s)" % (
            os.path.exists(wa), os.path.exists(wb))
    if walls(wa) != walls(wb):
        return "static.map wall sets differ"

    va = os.path.join(ref_dir, "video_1.txt")
    vb = os.path.join(tpu_dir, "video_1.txt")
    if not (os.path.exists(va) and os.path.exists(vb)):
        return "video_1.txt missing (ref %s, tpu %s)" % (
            os.path.exists(va), os.path.exists(vb))

    def frames(path):
        out = []
        for line in open(path):
            parts = line.split()
            if parts[0] == "F":
                out.append({"header": tuple(parts[1:]), "food": [],
                            "snake": []})
            else:
                _id, hp, d, x, y, group = parts
                rec = (hp, d, x, y, group)
                (out[-1]["food"] if group == "1"
                 else out[-1]["snake"]).append(rec)
        return out

    fa, fb = frames(va), frames(vb)
    if len(fa) != len(fb):
        return "frame counts differ: %d vs %d" % (len(fa), len(fb))
    for k, (a, b) in enumerate(zip(fa, fb)):
        if a["header"] != b["header"]:
            return "frame %d headers differ: %s vs %s" % (
                k, a["header"], b["header"])
        if sorted(a["food"]) != sorted(b["food"]):
            return "frame %d food sets differ" % k
        if a["snake"] != b["snake"]:
            return "frame %d snake segments differ" % k
    return None


def cli():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reference", default="/tmp/refbuild")
    parser.add_argument("--against", choices=["ref", "cpu"], default="ref",
                        help="the baseline leg: the C++ build or a second "
                             "port leg")
    parser.add_argument("--seeds", type=int, default=10)
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--render", action="store_true",
                        help="also dump + structurally compare replays")
    parser.add_argument("--child", choices=["ref", "port"])
    parser.add_argument("--spec")
    parser.add_argument("--out")
    parser.add_argument("--render-dir")
    parser.add_argument("--device", default=None,
                        help="default: the card (raises without one)")
    return parser


def main(argv=None):
    """-> the number of failed seeds."""
    args = cli().parse_args(argv)
    if args.child:
        child(args.child, json.loads(args.spec), args.out, args.reference,
              render_dir=args.render_dir)
        return 0
    device = str(resolve_device(args.device))
    legs = [("ref", "ref", "cpu") if args.against == "ref"
            else ("cpu", "port", "cpu"), ("port", "port", device)]
    base = legs[0][0]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    failures = 0
    for seed in range(args.start, args.start + args.seeds):
        spec = random_spec(seed)
        traces = {}
        render_fail = None
        with tempfile.TemporaryDirectory() as td:
            for name, leg, dev in legs:
                out = os.path.join(td, name + ".npz")
                cmd = [sys.executable, "-m",
                       "magent_tpu_torch.tools.fuzz_snake", "--child", leg,
                       "--spec", json.dumps(spec), "--out", out,
                       "--reference", args.reference, "--device", dev]
                if args.render:
                    rdir = os.path.join(td, name + "_render")
                    os.makedirs(rdir, exist_ok=True)
                    cmd += ["--render-dir", rdir]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=600, env=env)
                if proc.returncode != 0:
                    print("seed %d %s CRASHED:\n%s" % (
                        seed, name, proc.stderr[-1500:]), flush=True)
                    break
                traces[name] = dict(np.load(out))
            if args.render and len(traces) == 2:
                render_fail = compare_replays(
                    os.path.join(td, base + "_render"),
                    os.path.join(td, "port_render"))
        if len(traces) != 2:
            failures += 1
            continue
        if render_fail:
            failures += 1
            print("seed %d FAILED: %s" % (seed, render_fail), flush=True)
            continue
        ref, ours = traces[base], traces["port"]
        try:
            assert set(ref) == set(ours), set(ref) ^ set(ours)
            for key, rv in ref.items():
                where = "seed %d %s" % (seed, key)
                if key.startswith(("rew", "view0", "feat0")):
                    np.testing.assert_allclose(ours[key], rv, atol=1e-5,
                                               err_msg=where)
                else:
                    np.testing.assert_array_equal(ours[key], rv,
                                                  err_msg=where)
            print("seed %d ok (%d steps, %s)"
                  % (seed, int(ref["steps"]),
                     {k: spec[k] for k in ("map_width", "n_agents",
                                           "n_food")}),
                  flush=True)
        except AssertionError as e:
            failures += 1
            print("seed %d FAILED: %s" % (seed, str(e)[:500]), flush=True)
    print("done: %d/%d seeds passed" % (args.seeds - failures, args.seeds))
    return failures


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
