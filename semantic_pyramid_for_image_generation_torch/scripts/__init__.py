"""Evaluation entry points, counterparts of the repository's scripts/:
`artifact_selftest` (which artifacts are present, and each evaluation they
unlock through the production wiring) and `fid_rehearsal` (the whole FID
pipeline at 10k images on the card). Run each with `python -m`."""
