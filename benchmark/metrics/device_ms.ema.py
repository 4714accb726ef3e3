"""Device time per step of the operations launched under the program's
`sp:step.ema` span (BigGAN-deep's update of G's exponential moving
average), in the sub-window traced with shapes (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.ms_per_step(
        run, "device_us", lambda name: name == "step.ema")
