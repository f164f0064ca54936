"""Timing and output formatting."""
