"""Deterministic relation builders (numpy only)."""
