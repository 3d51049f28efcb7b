"""Mesh construction, sharding rules and the collectives of the port (port
of ``magent_tpu/parallel/sharding.py``).

The JAX package runs one SPMD program over a ``("dp", "tp")`` device mesh
and lets XLA insert the collectives.  The port runs one process per device
under ``torch.distributed`` (``nccl`` between cards, ``gloo`` on the CPU or
for several ranks sharing one card) and places the same axes by hand:

- ``dp``: each rank steps its own slice of the env batch
  (``VecGridWorld(..., mesh=mesh)``) and computes gradients on its own
  transitions; the trainers all-reduce the losses' counts and the
  gradients over the venv's ``dp``;
- ``tp``: the wide matmuls of the nets run column-parallel: each rank of a
  ``tp`` group holds ``out / tp`` rows of an ``nn.Linear`` weight, computes
  its slice of the output and all-gathers it (:func:`linear`,
  :func:`matmul`).

Sharding changes placement, never values: a run at world size 1 is the
unsharded run bit for bit (no collective runs), and a sharded run
equals the unsharded one on the rows each rank holds, up to the order of
the sums the collectives take.

:func:`state_sharding`, :func:`param_sharding` and :func:`replicated` give
trees of :class:`Sharding` as the JAX functions give ``NamedSharding``s;
:func:`device_put` keeps the rank's local part of a full tree (its env
rows, its weight rows) and :func:`gather` rebuilds the full tree on every
rank.  Every collective of the port goes through :func:`all_reduce` or
:func:`all_gather`.
"""

from __future__ import annotations

import atexit
import dataclasses
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..core.state import FIELDS, State
from ..spans import span
from .optim import AdamState
from .vec_env import resolve_device

AXES = ("dp", "tp")


class Mesh:
    """This rank's view of a ``(dp, tp)`` mesh of ``dp * tp`` ranks, one
    device each: its coordinates, its device and the process group of each
    axis (``None`` for an axis of size 1, which runs no collective).
    Rank ``r`` sits at ``(r // tp, r % tp)``, as ``reshape(dp, tp)`` of the
    JAX mesh's device list."""

    def __init__(self, dp: int, tp: int, rank: int, device: torch.device,
                 groups: dict):
        self.shape = {"dp": dp, "tp": tp}
        self.size = dp * tp
        self.rank = rank
        self.coord = {"dp": rank // tp, "tp": rank % tp}
        self.device = device
        self.groups = groups

    def __deepcopy__(self, memo):
        # nets carry their mesh; a deep copy (a target net) shares it
        return self

    def __repr__(self):
        return "Mesh(dp=%d, tp=%d, rank=%d, device=%s)" % (
            self.shape["dp"], self.shape["tp"], self.rank, self.device)


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(n_devices: int | None = None, tp: int = 1,
              devices=None) -> Mesh:
    """Build this rank's ``("dp", "tp")`` mesh over ``n_devices`` ranks
    (default: the world size; the port runs one device per rank, so it
    must equal the world size).  ``devices``: one device per rank, this
    rank taking ``devices[rank]``, or one device for every rank (``"cpu"``
    for gloo CPU ranks); by default the card of the rank's local index
    (``LOCAL_RANK``, else the rank, modulo the visible cards), and a
    ``cuda`` device with no card raises.  Without a process group a
    single-rank group is started (``nccl`` on a card, ``gloo`` on the
    CPU): a plain run needs no launcher."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * (dist.get_world_size()
                               if dist.is_initialized() else 1)
    if not dist.is_initialized():
        first = resolve_device(None if devices is None else devices[0])
        dist.init_process_group(_backend_for(first), store=dist.HashStore(),
                                rank=0, world_size=1)
        atexit.register(_destroy_own_group)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is None:
        n_devices = world
    assert n_devices % tp == 0, (n_devices, tp)
    if n_devices != world:
        raise ValueError("the port runs one device per rank: a mesh of %d "
                         "devices needs %d ranks, the world has %d"
                         % (n_devices, n_devices, world))
    if devices is not None:
        device = resolve_device(devices[rank])
    else:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises: no card
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = resolve_device(
            torch.device("cuda", local % torch.cuda.device_count()))
    dp = n_devices // tp
    members = {"dp": [[d * tp + t for d in range(dp)] for t in range(tp)],
               "tp": [[d * tp + t for t in range(tp)] for d in range(dp)]}
    groups = {"dp": None, "tp": None}
    for axis in AXES:
        if len(members[axis][0]) == 1:
            continue
        # every rank creates every group, in the same order
        for ranks in members[axis]:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(dp, tp, rank, device, groups)


def _destroy_own_group():
    """At exit, the one-rank group :func:`make_mesh` started (if the
    program has not destroyed it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- collectives
def _via_host(t: torch.Tensor, group) -> bool:
    """``gloo`` takes CPU tensors only: a card tensor is copied through
    host memory, explicitly (on one card the ranks share, NCCL refuses the
    group)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over the mesh axis ``axis`` (a new tensor; ``t``
    itself where the axis has one rank)."""
    group = mesh.groups[axis]
    if group is None:
        return t
    if _via_host(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The parts of ``t`` of the ranks of the mesh axis ``axis``,
    concatenated along ``dim`` in the axis's order."""
    group = mesh.groups[axis]
    if group is None:
        return t
    src = t.detach().contiguous()
    host = _via_host(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if host else out


def all_reduce_flat(tensors, mesh: Mesh, axis: str):
    """Sum a list of tensors of one dtype (a net's gradients) over
    ``axis`` in one collective on their flat concatenation."""
    if mesh.groups[axis] is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    with span("mesh.all_reduce"):
        flat = all_reduce(flat, mesh, axis)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def sum_dp(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``t`` summed over the ``dp`` ranks (``t`` itself without a mesh or
    with one ``dp`` rank)."""
    return t if mesh is None else all_reduce(t, mesh, "dp")


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the input gradient summed over ``tp`` backward
    (each rank's weight rows contribute their part of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, "tp"), None


class _GatherFromTP(torch.autograd.Function):
    """All-gather of the last dim forward; this rank's columns of the
    (replicated) output gradient backward."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        ctx.width = y.shape[-1]
        return all_gather(y, mesh, "tp", y.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        i = ctx.mesh.coord["tp"]
        return grad[..., i * ctx.width:(i + 1) * ctx.width], None


def split_of(module: nn.Module, leaf: str):
    """The :class:`Sharding` of ``module``'s parameter ``leaf`` where it is
    a ``tp`` shard, else None."""
    return getattr(module, "tp_split", {}).get(leaf)


def param_splits(net: nn.Module) -> list:
    """:func:`split_of` of each of ``net``'s parameters, in
    ``net.parameters()`` order."""
    out = []
    for name, _ in net.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        out.append(split_of(net.get_submodule(mod_name), leaf))
    return out


def matmul(x: torch.Tensor, w: torch.Tensor, split=None) -> torch.Tensor:
    """``x @ w`` of an ``[in, out]`` matrix; where ``split`` (the ``tp``
    :class:`Sharding` of ``w``'s columns) is given, ``w`` is this rank's
    ``[in, out / tp]`` and its slice of the product is all-gathered."""
    if split is None:
        return x @ w
    mesh = split.mesh
    return _GatherFromTP.apply(_CopyToTP.apply(x, mesh) @ w, mesh)


def linear(layer: nn.Module, x: torch.Tensor, dt, op=F.linear):
    """``op(x, weight, bias)`` of ``layer`` in ``dt``; where ``tp`` splits
    an ``nn.Linear``'s weight rows, the rows' outputs all-gathered
    (:func:`matmul`), then the replicated bias added."""
    bias = None if layer.bias is None else layer.bias.to(dt)
    split = split_of(layer, "weight")
    if split is None:
        return op(x, layer.weight.to(dt), bias)
    y = matmul(x, layer.weight.to(dt).t(), split)
    return y if bias is None else y + bias


# ------------------------------------------------------------------ shardings
@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor split along ``dim`` over the mesh axis ``axis``, or
    replicated (``axis`` None): the port's ``NamedSharding``."""

    mesh: Mesh
    axis: str | None = None
    dim: int = 0

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the full tensor ``t`` (a copy on the mesh's
        device)."""
        t = t.detach().to(self.mesh.device)
        if self.axis is None:
            return t.clone()
        n, i = self.mesh.shape[self.axis], self.mesh.coord[self.axis]
        size = t.shape[self.dim]
        if size % n:
            raise ValueError("dim %d of size %d does not split over %s=%d"
                             % (self.dim, size, self.axis, n))
        return t.narrow(self.dim, i * (size // n), size // n).clone()

    def full(self, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of the local parts ``t`` of every rank."""
        if self.axis is None:
            return t.detach()
        return all_gather(t, self.mesh, self.axis, self.dim)


def _tree_map(fn, tree):
    if isinstance(tree, State):
        return State(**{f: fn(getattr(tree, f)) for f in FIELDS})
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def state_sharding(mesh: Mesh, state_or_tree):
    """Shard every leaf's leading (env-batch) axis over ``dp``."""
    sh = Sharding(mesh, "dp", 0)
    return _tree_map(lambda _: sh, state_or_tree)


def replicated(mesh: Mesh, tree):
    sh = Sharding(mesh)
    return _tree_map(lambda _: sh, tree)


def _named(params) -> dict:
    return (dict(params.named_parameters()) if isinstance(params, nn.Module)
            else params)


def param_sharding(mesh: Mesh, params, tp_axis_min: int = 128):
    """Replicate parameters; shard wide matmul output dims over ``tp``
    (JAX's rule in the torch layout).

    ``params``: a net (its parameters by name), a ``{name: tensor}`` dict,
    or a list or tuple of those -> the same structure of ``{name:
    Sharding}``.  A 2-D tensor whose output width is at least
    ``tp_axis_min`` and divisible by the ``tp`` size is split along its
    output dim: dim 0 of an ``nn.Linear`` ``weight`` ``[out, in]`` (a flax
    kernel ``[in, out]`` split on its columns), dim 1 of any other 2-D
    leaf, which keeps flax's layout (CommNet's ``step_<i>_C``, see
    :mod:`..builtin.torch_model.flax_params`).  Everything else (biases,
    conv kernels, scalars) is replicated."""
    tp = mesh.shape["tp"]

    def rule(name, t):
        out = 0 if name.rsplit(".", 1)[-1] == "weight" else 1
        if (tp > 1 and t.dim() == 2 and t.shape[out] >= tp_axis_min
                and t.shape[out] % tp == 0):
            return Sharding(mesh, "tp", out)
        return Sharding(mesh)

    if isinstance(params, (list, tuple)):
        return type(params)(param_sharding(mesh, p, tp_axis_min)
                            for p in params)
    return {name: rule(name, t) for name, t in _named(params).items()}


def _put_net(net: nn.Module, shardings: dict) -> nn.Module:
    """Keep ``net``'s local parameter parts in place and record the
    shardings of its ``tp`` shards on their modules (:func:`split_of`),
    where the nets' forward and the optimizer read them."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            sh = shardings[name]
            p.data = sh.local(p.data)
            if sh.axis is not None:
                mod_name, _, leaf = name.rpartition(".")
                owner = net.get_submodule(mod_name)
                owner.__dict__.setdefault("tp_split", {})[leaf] = sh
    return net


def device_put(tree, shardings):
    """This rank's part of the full ``tree`` under ``shardings`` (the
    port's ``jax.device_put(tree, sharding)``).  A net is placed in place
    (its parameters become their local parts) and returned; an
    ``AdamState`` takes its net's ``{name: Sharding}`` (its moments are in
    ``net.parameters()`` order); a State, dict, list or tuple maps leaf by
    leaf."""
    if isinstance(tree, nn.Module):
        return _put_net(tree, shardings)
    if isinstance(tree, AdamState):
        shs = list(shardings.values())
        return AdamState(count=tree.count,
                         mu=[s.local(m) for s, m in zip(shs, tree.mu)],
                         nu=[s.local(v) for s, v in zip(shs, tree.nu)])
    if isinstance(tree, State):
        return State(**{f: getattr(shardings, f).local(getattr(tree, f))
                        for f in FIELDS})
    if isinstance(tree, dict):
        return {k: device_put(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_put(v, s) for v, s in zip(tree, shardings))
    return shardings.local(tree)


def gather(tree, shardings=None):
    """The full tree of every rank's local parts (a collective: every rank
    calls it).  A placed net gives its full ``state_dict`` (what the flax
    converters and checkpoints need) and takes no ``shardings``; an
    ``AdamState`` takes its net's ``{name: Sharding}``."""
    if isinstance(tree, nn.Module):
        return {name: p.detach().clone() if sh is None else sh.full(p)
                for (name, p), sh in zip(tree.named_parameters(),
                                         param_splits(tree))}
    if isinstance(tree, AdamState):  # with its net's {name: Sharding}
        shs = list(shardings.values())
        return AdamState(count=tree.count,
                         mu=[s.full(m) for s, m in zip(shs, tree.mu)],
                         nu=[s.full(v) for s, v in zip(shs, tree.nu)])
    if isinstance(tree, State):
        return State(**{f: getattr(shardings, f).full(getattr(tree, f))
                        for f in FIELDS})
    if isinstance(tree, dict):
        return {k: gather(v, None if shardings is None else shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        shs = [None] * len(tree) if shardings is None else shardings
        return type(tree)(gather(v, s) for v, s in zip(tree, shs))
    return shardings.full(tree)
