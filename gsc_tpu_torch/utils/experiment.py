"""Experiment bookkeeping: result directories, input copies, result.yaml,
and picking the best of several runs.

The port of ``gsc_tpu.utils.experiment``.  ``setup_result_dir`` makes
``<base>/<experiment id or "default">/<timestamp>`` (numbered when two
runs start within a second); ``copy_inputs`` copies the run's config
files to ``<run>/inputs``; ``ExperimentResult`` records wall and process
seconds per phase and the final metrics in ``result.yaml``, written by
this module's own YAML emitter (PyYAML is not required);
``select_best_agent`` picks the run with the best mean return over its
last ``last_k`` episodes of ``rewards.csv``.
"""
from __future__ import annotations

import csv
import json
import math
import os
import re
import shutil
import time
from datetime import datetime
from typing import Dict, List, Optional

_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        return repr(v)
    return json.dumps(str(v))   # a JSON string is a YAML double-quoted one


def _key(k) -> str:
    k = str(k)
    return k if _PLAIN_KEY.match(k) and k not in ("null", "true", "false") \
        else json.dumps(k)


def to_yaml(obj, indent: int = 0) -> str:
    """Block-style YAML of nested dicts, lists and scalars (what
    ``yaml.safe_dump(obj, default_flow_style=False)`` reads back as
    ``obj``)."""
    pad = " " * indent
    if isinstance(obj, dict):
        if not obj:
            return pad + "{}\n"
        out = []
        for k, v in obj.items():
            if isinstance(v, (dict, list, tuple)) and v:
                out.append(f"{pad}{_key(k)}:\n{to_yaml(v, indent + 2)}")
            else:
                empty = "{}" if isinstance(v, dict) else "[]"
                val = empty if isinstance(v, (dict, list, tuple)) \
                    else _scalar(v)
                out.append(f"{pad}{_key(k)}: {val}\n")
        return "".join(out)
    if isinstance(obj, (list, tuple)):
        if not obj:
            return pad + "[]\n"
        out = []
        for v in obj:
            if isinstance(v, (dict, list, tuple)) and v:
                body = to_yaml(v, indent + 2)
                out.append(f"{pad}-\n{body}")
            else:
                out.append(f"{pad}- {_scalar(v)}\n")
        return "".join(out)
    return pad + _scalar(obj) + "\n"


class ExperimentResult:
    """Phase-timed experiment record, written to ``result.yaml``."""

    def __init__(self, result_dir: str):
        self.result_dir = result_dir
        self.env_config: Dict[str, object] = {}
        self.agent_config: Dict[str, object] = {}
        self._timers: Dict[str, Dict[str, float]] = {}
        self.metrics: Dict[str, object] = {}

    def runtime_start(self, phase: str):
        self._timers[phase] = {"wall_start": time.time(),
                               "process_start": time.process_time()}

    def runtime_stop(self, phase: str):
        t = self._timers[phase]
        t["wall_time"] = time.time() - t.pop("wall_start")
        t["process_time"] = time.process_time() - t.pop("process_start")

    def write(self) -> str:
        os.makedirs(self.result_dir, exist_ok=True)
        record = {"env_config": self.env_config,
                  "agent_config": self.agent_config,
                  "runtimes": self._timers, "metrics": self.metrics}
        path = os.path.join(self.result_dir, "result.yaml")
        with open(path, "w") as f:
            f.write(to_yaml(record))
        return path


def setup_result_dir(base: str, experiment_id: Optional[str] = None) -> str:
    """``<base>/<id or "default">/<timestamp>``, made unique with a
    numeric suffix when two runs start within one second."""
    ts = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    root = os.path.join(base, experiment_id or "default")
    d = os.path.join(root, ts)
    i = 1
    while True:
        try:
            os.makedirs(d)
            return d
        except FileExistsError:
            d = os.path.join(root, f"{ts}_{i}")
            i += 1


def copy_inputs(result_dir: str, paths: List[Optional[str]]):
    """Copy the run's input config files to ``<result_dir>/inputs``."""
    dst = os.path.join(result_dir, "inputs")
    os.makedirs(dst, exist_ok=True)
    for p in paths:
        if p and os.path.isfile(p):
            shutil.copy(p, dst)


def select_best_agent(result_dirs: List[str], last_k: int = 10) -> str:
    """The run whose ``rewards.csv`` (field ``r``) has the best mean over
    its last ``last_k`` episodes."""
    best_dir, best = None, -float("inf")
    for d in result_dirs:
        path = os.path.join(d, "rewards.csv")
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            rewards = [float(row["r"]) for row in csv.DictReader(f)]
        if not rewards:
            continue
        mean = sum(rewards[-last_k:]) / len(rewards[-last_k:])
        if mean > best:
            best, best_dir = mean, d
    if best_dir is None:
        raise ValueError("no run with a readable rewards.csv")
    return best_dir
