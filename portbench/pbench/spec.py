"""Find the benchmark's data files by name.

Everything that belongs to one cell, configuration, scheme, traffic mix or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` or the cell's file gives:

    workloads/<cell>.json    the cell: config, scheme, traffic, slots, limits
    configs/<config>/config.json   the model's published config.json (as run)
    schemes/<scheme>.json    the KV storage scheme and its quantizer draws
    traffic/<traffic>.json   the traffic mix's parameters
    metrics/<metric>.py      a per-layer metric's reader, ``read(run)``

A later change adds a cell, a configuration, a scheme, a mix or a metric by
adding such files; no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = REPO) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _load(os.path.join(root, "BENCHMARK.json"))


def config_dir(name: str, base: str = ROOT) -> str:
    return os.path.join(base, "configs", name)


def config(name: str, base: str = ROOT) -> dict:
    return _load(os.path.join(config_dir(name, base), "config.json"))


def scheme(name: str, base: str = ROOT) -> dict:
    return _load(os.path.join(base, "schemes", f"{name}.json"))


def traffic(name: str, base: str = ROOT) -> dict:
    return _load(os.path.join(base, "traffic", f"{name}.json"))


def workload(name: str, base: str = ROOT) -> dict:
    return _load(os.path.join(base, "workloads", f"{name}.json"))


def metric_reader(name: str, base: str = ROOT):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, name: str, base: str = ROOT) -> dict:
    """Everything one cell runs with: its ``BENCHMARK.json`` entry, its
    file, and the configuration, scheme and traffic files those name; the
    end-to-end and per-layer metrics it reports."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = workload(name, base)
    if wl["config"] != entry["config"]:
        raise SystemExit(f"workloads/{name}.json names config "
                         f"{wl['config']!r}, BENCHMARK.json {entry['config']!r}")

    def reports(m):
        return name in m.get("workloads", [name])

    return dict(
        name=name, entry=entry, workload=wl,
        config_name=entry["config"], config=config(entry["config"], base),
        config_path=config_dir(entry["config"], base),
        scheme=scheme(wl["scheme"], base),
        traffic=traffic(entry["traffic"], base),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)],
    )
