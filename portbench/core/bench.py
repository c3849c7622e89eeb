"""Finding the pieces of a cell by name. BENCHMARK.json, at the checkout's
root, names each cell's configuration, traffic and chips and lists the
metrics each cell reports; every piece lives in a file of its own under
one of the search folders (the benchmark's own folder by default):

  configs/<config>.json     the configuration (the manifest's `file`)
  traffic/<traffic>.json    the traffic mix: its "loop" and that loop's
                            parameters
  loops/<loop>.py           a traffic loop (see `core.window`)
  e2e/<metric>.py           an end-to-end metric's reader
  metrics/<metric>.py       a per-layer metric's reader
  roofline/<kernel>.py      a kernel's bytes and operations from shapes
  systems/<transform>.py    the system under test of a transform, its
                            reference and the numbers it compares

so that a later cell, metric or count is new files and manifest entries.
A reader is a module with `read(ctx)`, returning a number or None where
the run has nothing for it to read."""
from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class Bench:
    def __init__(self, manifest=None, dirs=(HERE,)):
        """`manifest`: BENCHMARK.json's content (read from the checkout's
        root if None); `dirs`: the folders searched, in order."""
        if manifest is None:
            with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
                manifest = json.load(f)
        self.manifest = manifest
        self.dirs = tuple(dirs)
        self._mods = {}

    def path(self, kind, name, ext):
        for d in self.dirs:
            p = os.path.join(d, kind, name + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under "
                                f"{', '.join(self.dirs)}")

    def json(self, kind, name):
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind, name):
        key = (kind, name)
        if key not in self._mods:
            p = self.path(kind, name, ".py")
            mod_name = f"portbench_{kind}_" + "".join(
                c if c.isalnum() else "_" for c in name)
            spec = importlib.util.spec_from_file_location(mod_name, p)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
            self._mods[key] = mod
        return self._mods[key]

    def cell(self, name):
        """(workload entry, configuration, traffic) of a cell."""
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                break
        else:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return (w, self.json("configs", w["config"]),
                self.json("traffic", w["traffic"]))

    def metrics(self, kind, cell):
        """The manifest's `kind` ('end_to_end' or 'per_layer') metrics that
        `cell` reports: those whose `workloads` list it, or that have no
        such list."""
        return [m for m in self.manifest[kind]
                if cell in m.get("workloads", [cell])]
