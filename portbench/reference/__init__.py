"""Part of the port's benchmark (see portbench/README.md)."""
