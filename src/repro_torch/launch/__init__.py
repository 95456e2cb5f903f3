"""Launchers: command-line drivers of the port's entry points."""
