"""Predator-prey pursuit (parity with reference builtin/config/pursuit.py).

NOTE on similarity: this file is a game PARAMETER TABLE — the
numeric attribute values and reward-rule declarations ARE the
parity contract with the reference config of the same name
(bit-equal semantics are required by the golden-trajectory tests),
so its text necessarily mirrors the reference's table.
"""

import magent_tpu_torch as magent


def get_config(map_size):
    gw = magent.gridworld
    cfg = gw.Config()

    cfg.set({"map_width": map_size, "map_height": map_size})

    predator = cfg.register_agent_type(
        "predator",
        {
            'width': 2, 'length': 2, 'hp': 1, 'speed': 1,
            'view_range': gw.CircleRange(5), 'attack_range': gw.CircleRange(2),
            'attack_penalty': -0.2
        })

    prey = cfg.register_agent_type(
        "prey",
        {
            'width': 1, 'length': 1, 'hp': 1, 'speed': 1.5,
            'view_range': gw.CircleRange(4), 'attack_range': gw.CircleRange(0)
        })

    predator_group = cfg.add_group(predator)
    prey_group = cfg.add_group(prey)

    a = gw.AgentSymbol(predator_group, index='any')
    b = gw.AgentSymbol(prey_group, index='any')

    cfg.add_reward_rule(gw.Event(a, 'attack', b), receiver=[a, b], value=[1, -1])

    return cfg


def layout(map_size, seed=11, wall_frac=0.0):
    """Explicit placements for ``VecGridWorld`` (multi-cell bodies need
    them): 1.25% of the map's cells as 2x2 predators and 2.5% as prey, at
    random free cells from ``numpy.random.RandomState(seed)``, as
    ``scripts/train_evidence.py:30-53`` (seed 11) and
    ``scripts/bench_pursuit.py:47-66`` (seed 5, NORTH) place them; then
    ``wall_frac`` of the cells as interior walls on cells left free, as
    many as ``examples/train_pursuit.py:18`` adds (it adds 3%).

    Returns ([predators, prey], walls): rows of (x, y, dir) and (x, y)."""
    import numpy as np

    n_pred = int(map_size * map_size * 0.0125)
    n_prey = int(map_size * map_size * 0.025)
    rng = np.random.RandomState(seed)
    taken = set()
    preds, prey = [], []
    while len(preds) < n_pred:
        x = int(rng.randint(1, map_size - 3))
        y = int(rng.randint(1, map_size - 3))
        block = [(x + dx, y + dy) for dx in range(2) for dy in range(2)]
        if not any(c in taken for c in block):
            taken.update(block)
            preds.append([x, y, 0])
    while len(prey) < n_prey:
        x = int(rng.randint(1, map_size - 2))
        y = int(rng.randint(1, map_size - 2))
        if (x, y) not in taken:
            taken.add((x, y))
            prey.append([x, y, 0])
    walls = []
    while len(walls) < int(map_size * map_size * wall_frac):
        x = int(rng.randint(1, map_size - 1))
        y = int(rng.randint(1, map_size - 1))
        if (x, y) not in taken:
            taken.add((x, y))
            walls.append([x, y])
    return [preds, prey], walls
