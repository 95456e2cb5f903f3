"""Bit packing: activations, dense 0/1 matrices and per-tile transposes."""
