"""The port's turn-mode observation on its kernel routes against the JAX
package's, on the CPU: the stacked-rotations route (``window_gather`` on
the four-band image) and the banded route (``window_gather_banded`` on it,
forced by shrinking ``VMEM_IMAGE_BUDGET`` in both packages) against the
JAX package's ``_make_observe_rotating`` with ``interpret=True`` (its
Pallas kernels in interpret mode, jitted: eager JAX divides the hp by its
maximum, jit folds that into the multiply the port does), bit for bit:
both groups, minimap on and off, f32 and bf16 views, on a stepped world
with every facing, dead agents and fractional hp.  The other routes and
cases: ``test_torch_port_turn_routes.py``.

Interpret-mode compiles take seconds each at these caps (32 slots per
group, map 20)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.core import engine as jengine
from magent_tpu.core import observe as jobserve

from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.core.state import state_from_numpy

from test_torch_port_turn import (DENSE, batched, jax_turn_world,
                                  turn_actions)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
CAPS = 16


@functools.lru_cache(maxsize=None)
def _world(minimap, food=False):
    """A JAX turn world of the packed ``DENSE`` layout stepped 6 times with
    turns, attacks and moves (no clear_dead: dead agents stay in their
    slots) -> (JAX spec, JAX state, port spec, port state)."""
    env, sp = jax_turn_world(caps=2 * CAPS, seed=5, placements=DENSE,
                             minimap=minimap, food=food)
    step = jax.jit(jengine.make_step(env.spec))
    js = env.state
    for i in range(6):
        js = step(js, jnp.asarray(turn_actions(sp, 1, 40 + i)[0]))
    return env.spec, js, sp, state_from_numpy(batched(js), "cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _assert_exact(got, want, tag):
    """Port (view, feature) [1, cap, ...] against JAX's [cap, ...]: the
    same dtype and bits."""
    for g, w, name in zip(got, want, ("view", "feature")):
        g = g[0]
        gn = (g.view(torch.int16) if g.dtype == torch.bfloat16 else g).numpy()
        np.testing.assert_array_equal(_bits(gn), _bits(w),
                                      err_msg="%s %s" % (tag, name))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("minimap", [False, True], ids=["plain", "minimap"])
@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("route", ["stacked", "banded"])
def test_kernel_routes_match_jax_interpret(route, group, minimap, dtype,
                                           monkeypatch):
    jspec, js, sp, ts = _world(minimap)
    tdt, jdt = DTYPES[dtype]
    if route == "banded":
        monkeypatch.setattr(jobserve, "VMEM_IMAGE_BUDGET", 1)
        monkeypatch.setattr(tobserve, "VMEM_IMAGE_BUDGET", 1)
    want = jax.jit(jobserve._make_observe_rotating(
        jspec, group, obs_dtype=jdt, interpret=True))(js)
    tobs = tobserve.make_observe(sp, group, tdt)
    assert tobs.route == ("window_gather" if route == "stacked"
                          else "window_gather_banded")
    assert tobs.grids_fn is None
    got = tobs(ts)
    assert got[0].dtype == tdt
    _assert_exact(got, want, "%s group %d" % (route, group))
    live = (ts.active & ~ts.dead)[0]
    assert sorted(np.unique(ts.dir[0][live].numpy())) == [0, 1, 2, 3]
    assert (ts.active & ts.dead).any()  # dead agents keep their windows


