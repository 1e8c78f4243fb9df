"""The general parts of the benchmark: finding a cell's files by name,
running a cell, reading the board and the profiler, the yardstick."""
