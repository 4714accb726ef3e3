"""Entry points, counterparts of the repository's scripts/: the evaluation
ones, `artifact_selftest` (which artifacts are present, and each evaluation
they unlock through the production wiring) and `fid_rehearsal` (the whole
FID pipeline at 10k images on the card), the training ones, `long_run`
(~2k steps through cli/main.py fed from JPEGs) and `loader_scaling_bench`
(the host feed per worker count against the card's step rate), and the
profiling ones, `profile_step` (the fused train step's per-op roofline and
its share of the card's peak) and the formulation microbenchmarks
`finalblock_bench`, `inputconv_bwd_bench` and `s2d_stem_bench`. Run each
with `python -m`."""
