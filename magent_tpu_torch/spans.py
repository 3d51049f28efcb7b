"""Named spans around the program's phases, for ``torch.profiler`` traces.

``span(name)`` marks the work inside it with ``name`` while a torch
profiler records, and costs well under a microsecond when none does.  A
span is a ``cpu_op`` event of the profiler's trace, on the same clock as
the device events, so a trace reader can give each device operation to
the spans that held its launch.  Spans are not ``user_annotation`` events:
readers of ``record_function`` ranges around the program's calls see the
same ranges with or without them.

A span's name is ``<layer>.<part>``, with a dot and no ``::`` (PyTorch's
own operators have ``::``):

- ``train``: a fused trainer's ``rollout`` and ``learn`` halves;
- ``net``: the acting forward (``net.act``); the recurrent cell
  (``net.gru``: a ``GRUCell`` step, and each carry step of
  ``split_unroll``, inside what a checkpoint recomputes) and a whole
  ``split_unroll`` (``net.unroll``);
- ``observe``: the packed grid pass, the channel render, the pooled
  minimap, the window gather with its epilogue, and the feature vector
  (``observe.grids``, ``.render``, ``.minimap``, ``.window``,
  ``.features``);
- ``env``: ``VecGridWorld``'s ``observe`` and ``transition``;
- ``rng``: each public draw of :mod:`magent_tpu_torch.random`, nested
  where one draw calls another;
- ``mesh``: the gradients' collective over a mesh axis
  (``mesh.all_reduce``, in ``sharding.all_reduce_flat``)."""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast


def span(name: str):
    """A context manager marking its work as span ``name`` in a torch
    profiler's trace."""
    return _RecordFunctionFast(name)
