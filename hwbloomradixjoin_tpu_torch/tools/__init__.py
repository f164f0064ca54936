"""Validation runs of the port on the card (counterparts of the repository's
tools/validate_fullrange.py and tools/validate_bloom_tpu.py)."""
