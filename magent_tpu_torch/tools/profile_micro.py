"""Micro-costs of the engine's pair kernels and primitive ops at battle
scale (B=16, A=2048; port of ``scripts/profile_micro.py``).

Each variant runs its body ``STEPS`` times per call, a warm-up call and
``CALLS`` timed calls, timed with CUDA events (the JAX script scans the
body in one jitted program).  ``rank_prefix`` packs fresh ranks
(``pack_rank``) and runs the order-aware damage prefix (PERF.md §6 row 3),
``move_claims`` the grid path's move contention (row 6); each ``_plain``
variant runs the same body on the kernel's plain PyTorch version.  The
primitives the engine's step is built of, as PyTorch runs them:
``row_gather`` (``gather`` of [B, A, 2] rows by slot), ``scatter_max``
(``scatter_reduce`` amax into A + 1 cells), ``scatter_set`` (``scatter``
of [B, A, 2] rows; of slots that share a cell one write wins, which one
unspecified, as in XLA) and ``rand_bits`` (the threefry ``split`` and
``bits`` of ``magent_tpu_torch.random``, equal to ``jax.random.bits``).

    python -m magent_tpu_torch.tools.profile_micro [name ...] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from .. import random as rnd
from ..ops import attack_prefix as ap
from ..parallel import resolve_device
from .timing import elapsed_ms

B = 16
A = 2048
STEPS = 64
CALLS = 3
VARIANTS = ("rank_prefix", "rank_prefix_plain", "move_claims",
            "move_claims_plain", "row_gather", "scatter_max", "scatter_set",
            "rand_bits")


def rank_prefix_variant(prefix):
    """``profile_micro.py:50-62`` with ``prefix`` the damage prefix."""
    def init(key):
        tgt = rnd.randint(key, (B, A), -1, A)
        dmg = torch.ones((B, A), device=key.device)
        return (tgt, dmg, rnd.PRNGKey(1, key.device))

    def body(c):
        tgt, dmg, key = c
        key, k2 = rnd.split(key).unbind(-2)
        rank = ap.pack_rank(rnd.bits(k2, (B, A)), A)
        P = prefix(tgt, rank, dmg)
        return (tgt, dmg, key), P[:, ::256].sum()

    return init, body


def move_claims_variant(claims):
    """``profile_micro.py:66-76`` with ``claims`` the contention sweep."""
    def init(key):
        return (rnd.randint(key, (B, A), 0, 40000),
                torch.zeros((B,), device=key.device))

    def body(c):
        tcell, acc = c
        cnt, head = claims(tcell)
        s = (cnt[:, ::256] + head[:, ::256]).sum(1).float()
        return (tcell + 1, acc + s), s.sum()

    return init, body


def row_gather(vals, idx):
    """``take_along_axis(vals, idx[..., None], axis=1)``: vals [B, A, 2],
    idx [B, A] -> [B, A, 2]."""
    return vals.gather(1, idx.long()[..., None].expand(vals.shape))


def scatter_max(vals, idx):
    """``zeros(A + 1).at[idx].max(vals)[:A]`` per env: [B, A] -> [B, A]."""
    out = torch.zeros((vals.shape[0], A + 1), device=vals.device)
    return out.scatter_reduce(1, idx.long(), vals, "amax")[:, :A]


def scatter_set(vals, idx):
    """``zeros((A + 1, 2)).at[idx].set(vals)[:A]`` per env: [B, A, 2] ->
    [B, A, 2]; where slots share a cell, one of their values (each lane
    on its own)."""
    out = torch.zeros((vals.shape[0], A + 1, 2), device=vals.device)
    return out.scatter(1, idx.long()[..., None].expand(vals.shape),
                       vals)[:, :A]


def rand_bits(key):
    """-> (the next key, ``bits`` [B, A] of the other half of its split)."""
    key, k2 = rnd.split(key).unbind(-2)
    return key, rnd.bits(k2, (B, A))


def primitive_variant(fn, normal=False, width=2):
    """``profile_micro.py:80-123``: ``fn(vals, idx)`` on values drawn from
    the key (normal or uniform, [B, A, width] or [B, A] for width None) and
    slots from ``PRNGKey(3)``, each step's values moved by 1e-6 and slots
    by 1."""
    def init(key):
        shape = (B, A) if width is None else (B, A, width)
        vals = rnd.normal(key, shape) if normal else rnd.uniform(key, shape)
        return (vals, rnd.randint(rnd.PRNGKey(3, key.device), (B, A), 0, A))

    def body(c):
        vals, idx = c
        out = fn(vals, idx)
        return (vals + 1e-6, (idx + 1) % A), out[:, ::256].sum()

    return init, body


def rand_bits_variant():
    """``profile_micro.py:125-134``."""
    def init(key):
        return key

    def body(key):
        key, b = rand_bits(key)
        return key, b[:, ::256].float().sum()

    return init, body


def variant(name):
    return {
        "rank_prefix": lambda: rank_prefix_variant(ap.rank_prefix),
        "rank_prefix_plain": lambda: rank_prefix_variant(ap.rank_prefix_ref),
        "move_claims": lambda: move_claims_variant(ap.move_claims),
        "move_claims_plain": lambda: move_claims_variant(ap.move_claims_ref),
        "row_gather": lambda: primitive_variant(row_gather, normal=True),
        "scatter_max": lambda: primitive_variant(scatter_max, width=None),
        "scatter_set": lambda: primitive_variant(scatter_set),
        "rand_bits": rand_bits_variant,
    }[name]()


def run(body, carry, steps):
    """``steps`` iterations of ``body`` -> (carry, summed sink)."""
    sinks = []
    for _ in range(steps):
        carry, s = body(carry)
        sinks.append(s)
    return carry, torch.stack(sinks).sum()


@torch.no_grad()
def timed(name, device):
    """Variant ``name``: a warm-up call, then ``CALLS`` timed calls of
    ``STEPS`` steps -> (ms per step, the warm-up call's sink)."""
    steps, calls = STEPS, CALLS
    init, body = variant(name)
    carry = init(rnd.PRNGKey(0, device))
    carry2, sink = run(body, carry, steps)
    warm = float(sink)
    out = [carry2]

    def call():
        out[0], _ = run(body, out[0], steps)

    ms = elapsed_ms(call, calls, device) / (steps * calls)
    print("%-18s %7.3f ms/step" % (name, ms), flush=True)
    return ms, warm


def cli():
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap_.add_argument("names", nargs="*", default=list(VARIANTS),
                     help="of %s" % " ".join(VARIANTS))
    ap_.add_argument("--device", default=None,
                     help="default: the card (raises without one)")
    return ap_


def main(argv=None):
    """-> {variant: (ms per step, warm-up sink)}."""
    ap_ = cli()
    args = ap_.parse_args(argv)
    if set(args.names) - set(VARIANTS):
        ap_.error("variants are %s" % " ".join(VARIANTS))
    device = resolve_device(args.device)
    return {name: timed(name, device) for name in args.names}


if __name__ == "__main__":
    main()
