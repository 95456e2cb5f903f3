"""Masked B2SR product reduction: the triangle-counting kernel."""
