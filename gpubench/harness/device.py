"""The card a run measures: the check that it is there, and its description."""

from __future__ import annotations

import os
import subprocess


class NoCard(RuntimeError):
    """The run asks for more cards than the machine holds."""


def require_cards(count):
    """The first card, after checking that ``count`` cards are there."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark runs on a card only")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell asks for {count} cards and {torch.cuda.device_count()} are there")
    return torch.device("cuda", 0)


def name_and_limit():
    """The first card's name and power limit as ``nvidia-smi`` prints them,
    or why they could not be read."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"not read ({exc})"


def card_state():
    """The first card's SM clock, temperature and power draw now, as
    ``nvidia-smi`` prints them, or why they could not be read."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"not read ({exc})"


class HostCpu:
    """This process's CPU seconds over a stretch of wall time: started when
    made, read by :meth:`line`; how much of the host a driver kept busy."""

    def __init__(self):
        self.times = os.times()

    def line(self):
        times = os.times()
        own = (times.user - self.times.user) + (times.system - self.times.system)
        wall = times.elapsed - self.times.elapsed
        return (f"host cpu over the window: this process {own:.2f} cpu-s in {wall:.2f} s "
                f"on {os.cpu_count()} cpus")


def describe(device, count, memory_peak):
    """The result's ``device`` entry."""
    import torch

    on_card = device.type == "cuda"
    return {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else device.type,
        "count": count,
        "memory_peak_bytes": int(memory_peak),
    }
