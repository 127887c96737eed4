"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
manifest gives, and a traffic mix, whose parameters are
``gpubench/traffic/<traffic>.json``; the traffic names the driver
(``gpubench/drivers/<driver>.py``) that runs it.  A metric applies to a
cell when its ``workloads`` list names the cell, or when it has no such
list.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def load(root=ROOT):
    """The manifest of the checkout at ``root``."""
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, read from the checkout."""

    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    chips: int


def applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell(name, root=ROOT, manifest=None):
    """The cell ``name`` of the manifest at ``root``; raises ``KeyError``
    for a name the manifest does not have."""
    root = Path(root)
    manifest = manifest or load(root)
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    work = by_name[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[work["config"]]["file"]).read_text())
    traffic = json.loads((root / "gpubench" / "traffic" / f"{work['traffic']}.json").read_text())
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(work["chips"]),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name)],
    )
