"""A cell of the benchmark, found by name.

Everything that belongs to one cell sits in files of its own, which later
changes add and never edit:

- ``portbench/workloads/<cell>.json``: the configuration and traffic it
  pairs, its chips and ``why``, and the limits of its output check;
- ``portbench/configs/<config>.json``: the model's widths, in the
  published ``net_kernel_params`` layout (:func:`as_run`), and the
  precision it is served or trained in;
- ``portbench/traffic/<traffic>.json``: the mix's parameters (mode, frames,
  frame size, lanes, TTA, the postprocess's or the optimizer's knobs);
- ``portbench/metrics/<metric>.py``: one per-layer metric's reader, a
  ``read(run)`` that returns a number or None;
- ``BENCHMARK.json`` at the checkout's root names the metrics and the cells
  each is read in.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    benchmark: Dict

    @property
    def mode(self) -> str:
        return self.traffic["mode"]

    def per_layer(self) -> List[Dict]:
        """The per-layer metrics ``BENCHMARK.json`` reads in this cell: those
        that list it, and those that list no cell but move an end-to-end
        metric that it reports."""
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.benchmark.get("per_layer", [])
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.benchmark["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]


def as_run(config: Dict) -> Dict:
    """A configuration file as the harness runs it. The file lists the
    decoder's conv stacks as the published ``net_kernel_params`` do: deepest
    level first, the last stack ending in the 1x1 output conv to the
    classes. The port and the reference index them by level, shallowest
    first, and add that output conv themselves (the head)."""
    up = [[tuple(k) for k in lvl] for lvl in config["up_conv_kernels"]][::-1]
    if not up[0] or up[0][-1] != (1, config["num_classes"]):
        raise ValueError(f"the last decoder stack has to end in the output conv "
                         f"(1, {config['num_classes']}), got {up[0]}")
    up[0] = up[0][:-1]
    return dict(config, up_conv_kernels=[[list(k) for k in lvl] for lvl in up])


def load(name: str, root: str = ROOT) -> Cell:
    bench = os.path.join(root, "portbench")
    workload = _json(bench, "workloads", f"{name}.json")
    return Cell(name, workload, as_run(_json(bench, "configs", f"{workload['config']}.json")),
                _json(bench, "traffic", f"{workload['traffic']}.json"),
                _json(root, "BENCHMARK.json"))


def metric_reader(name: str, root: str = ROOT) -> Callable[[object], Optional[float]]:
    """``read`` of ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
