"""The benchmark's harness: finding a cell's files by name, running a cell,
reducing its trace, and the arithmetic that turns both into metrics."""
