"""The files that a configuration, a cell or BENCHMARK.json names by a
name, each one function in a file of its own under the harness's root
(the folder of cells/ and configs/):

* genomes/<model>.py   genome(rng, spec, layout), a genome model;
* checks/<name>.py     check(ctx), a number of the check of `correct`;
* metrics/<name>.py    read(ctx), a per-layer metric.

A name with no such file, or a file without the function, is an error
when it is loaded, before any reads are written.
"""

from __future__ import annotations

import importlib.util
import os


def module(root: str, folder: str, name: str):
    """The module of <root>/<folder>/<name>.py."""
    path = os.path.join(root, folder, name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"pgbench: {name!r} names no file {folder}/{name}.py "
                         f"under {root}")
    spec = importlib.util.spec_from_file_location(f"pgbench_{folder}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: str, folder: str, name: str, attr: str):
    """The function `attr` of <root>/<folder>/<name>.py."""
    fn = getattr(module(root, folder, name), attr, None)
    if not callable(fn):
        raise ValueError(f"pgbench: {folder}/{name}.py under {root} has no "
                         f"function {attr}()")
    return fn
