"""Build a test's reference once per pytest run, for every xdist worker.

pytest-xdist runs a module's cases on several workers, and each worker
builds a module fixture again. ``shared`` follows the pattern pytest-xdist
documents for data shared between workers: the first worker to take the
lock builds the value and pickles it under the run's common base temp dir
(``tmp_path_factory.getbasetemp().parent``, one per run), the others wait
on the lock and load it. Without xdist the value is built in the process.
Values must pickle: keep them to numpy arrays and plain Python objects.
"""

from __future__ import annotations

import os
import pickle

from filelock import FileLock


def shared(tmp_path_factory, name: str, build):
    """``build()``, computed once per run under the key ``name``."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return build()
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = build()
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)
        return value
