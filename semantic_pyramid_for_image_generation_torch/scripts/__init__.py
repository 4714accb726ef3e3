"""Entry points, counterparts of the repository's scripts/: the evaluation
ones, `artifact_selftest` (which artifacts are present, and each evaluation
they unlock through the production wiring) and `fid_rehearsal` (the whole
FID pipeline at 10k images on the card), and the training ones, `long_run`
(~2k steps through cli/main.py fed from JPEGs) and `loader_scaling_bench`
(the host feed per worker count against the card's step rate). Run each
with `python -m`."""
