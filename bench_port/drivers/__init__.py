"""The traffic kinds: bench_port/drivers/<kind>.py holds everything of one
kind, found by the "kind" of a traffic mix, so that a new kind is a new
file. A kind's module gives

  RATE         the end-to-end metric that its window's units count (the
               result reads units x rays_per_unit / wall_s under it);
  FAULTS       {name: fault} planted under the timed path, the faults its
               cells can have (bench_port/faults.py holds the shared ones);
  CONTROL_NEEDS_CARD   whether the precision control means anything only
               on a CUDA card (a card setting, such as TF32);
  run(cell, fault=None) -> out   one run: set-up, the window or the
               traced window, then the plain reference; `out` holds
               "units", "rays_per_unit", "wall_s", "setup_s",
               "setup_parts", "memory_peak_bytes", "reference_s",
               "answers" and, traced, "trace" (trace.TraceReading) and
               "work" (the readers' work counts);
  numbers(out) -> {number: value}   what `check.verdict` compares (a
               cell's limits file picks which);
  control(cell) -> {number: value}  the same numbers for the precision
               control: the reference one precision down, in the
               program's place, against the reference.
"""
