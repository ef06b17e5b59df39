"""Entry drivers: one module per entry of the port that a window drives.
Each has `setup(run)`, `window(run)`, `free(run)` and `check(run)`."""
