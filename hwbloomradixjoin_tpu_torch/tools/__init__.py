"""The port's chip tools (counterparts of the repository's tools/):
validate_fullrange, validate_bloom (validate_bloom_tpu.py), validate_pro
(validate_tpu.py), build_check (tpu_build_check.py), part_bench,
microbench and validate_key8b."""
