"""One file per traffic kind (a traffic file's ``kind``), holding its
``Loop``: :data:`h100bench.loops.KINDS` finds the file by the kind's name.

A ``Loop(cfg, traffic, seed, device)`` is what :mod:`h100bench.run` drives,
and it asks the loop, never the kind's name, for:

- ``rate``: the name of the end-to-end rate it reports; ``window_steps``
  (the key of the metrics' ``ctx.window`` that counts the window's
  steps), ``unit`` (those steps in the log line) and ``steps_per_call``;
  ``attempted`` is the window's calls times ``steps_per_call``;
- ``warm()``, ``before_window(seconds, run_window)`` (set-up's last work,
  counted in ``setup_s``), ``call(rf)``, ``read_sink()``,
  ``after_window()`` and ``free()``;
- ``work_per_call()`` and ``agents_per_profiled_step``: agent-steps of a
  window's call and of a profiled step;
- ``context()``: what the per-layer metrics read beside the trace (set on
  the metrics' context); ``traced_context(count_syncs)``: what a
  ``--trace 1`` run adds before its profiled stretch (host syncs);
- ``profile(rf)``: the profiled stretch's steps, each under the
  benchmark's ranges ``rf`` -> their number;
- ``judge(cfg, traffic, seed, device)`` -> ({number: gap}, the number of
  steps checked), after the window, by :mod:`h100bench.check`;
- ``calibrate(cfg, traffic, seed, device, control)``: the readings that
  ``h100bench.calibrate`` prints for the limits, after the window."""
