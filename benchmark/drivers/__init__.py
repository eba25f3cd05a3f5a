"""Drivers, one per kind of cell: `setup(cell, seed, device)` builds the
program and its traffic (the run's set-up), `window(state, seconds, tracer)`
measures, `check(state)` frees the program and compares what the window
produced with the reference."""
