"""Synthetic graph generators (numpy, seeded)."""
