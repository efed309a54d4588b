"""The benchmark's data files, found by name: BENCHMARK.json at the
checkout's root, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py``.  A name with no
file is an error; nothing falls back to a default."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such benchmark file: {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(workload_name: str) -> dict:
    return _json(os.path.join(HERE, "limits", f"{workload_name}.json"))["limits"]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {metric!r}: {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload_name: str, kind: str) -> list:
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') this cell
    reports: those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind] if workload_name in m.get("workloads", [workload_name])]


def make_config(cls, fields: dict):
    """A config dataclass from a file's fields: lists become tuples, and
    a field the class lacks is an error."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - known
    if unknown:
        raise KeyError(f"configuration keys {sorted(unknown)} are not fields of {cls.__name__}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


def path_config(conf: dict, kind: str) -> dict:
    """The fields a configuration runs one path ('serve' or 'train') with:
    its model fields, then that path's own."""
    if kind not in conf["paths"]:
        raise KeyError(f"configuration {conf['name']!r} has no {kind!r} path")
    return {**conf["model"], **conf["paths"][kind]["fields"]}
