"""The files a cell names, found by name under the root of a checkout.

- a configuration's model family: ``families/<family>.py``, where
  ``family`` is the configuration file's key of that name (``zigma`` where
  the file has none); what a family holds is in ``families/__init__.py``;
- a traffic mix's kind of work: ``jobs/<kind>.py``, whose ``JOB`` is the
  job class (``jobs/__init__.py``);
- a per-layer metric's reader: ``metrics/<metric>.py``, whose ``read``
  takes the run and returns the metric's value or None.

Only the named file is loaded from under the ``root`` given; what it
imports (``portbench.weights``, ``portbench.reference``, another family)
resolves through ``sys.path`` as any import does.  A name with no file
raises ``SystemExit`` with the path that was looked for.
"""

from __future__ import annotations

import importlib.util
import os

__all__ = ["ROOT", "PACKAGE", "DEFAULT_FAMILY", "family", "job", "metric",
           "make_job", "path"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = os.path.basename(HERE)
DEFAULT_FAMILY = "zigma"


def path(root: str, folder: str, name: str, ext: str = ".json") -> str:
    """``<root>/portbench/<folder>/<name><ext>``."""
    return os.path.join(root, PACKAGE, folder, name + ext)


def _load(root: str, folder: str, name: str, what: str):
    where = path(root, folder, name, ".py")
    if not os.path.isfile(where):
        raise SystemExit(f"no {what} {name!r}: {where} not found")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}_{folder}_{name.replace('.', '_')}", where)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict, root: str = ROOT):
    """The model family module of a configuration."""
    return _load(root, "families", cfg.get("family", DEFAULT_FAMILY),
                 "model family")


def job(kind: str, root: str = ROOT):
    """The job class of a kind of work."""
    return _load(root, "jobs", kind, "kind of work").JOB


def metric(name: str, root: str = ROOT):
    """The reader of a per-layer metric."""
    return _load(root, "metrics", name, "reader of per-layer metric").read


def make_job(cfg: dict, traffic: dict, seed: int, device, root: str = ROOT):
    """The traffic's job over the configuration's family, built (the
    weights and inputs made, the program's model loaded)."""
    return job(traffic["kind"], root)(family(cfg, root), cfg, traffic, seed,
                                      device)
