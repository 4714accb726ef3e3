"""Device time per step of the operations launched under the program's
`sp:loop.to_device` span: the host-to-device copies of the batch (and
whatever they launch), in the sub-window traced with shapes
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.ms_per_step(
        run, "device_us", lambda name: name == "loop.to_device")
