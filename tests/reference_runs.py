"""Stored results of the reference interpreter's runs, for the port's
interpreter tests (``tests/test_torch_interp.py``,
``tests/test_torch_deferred.py``, ``tests/test_torch_interp_run.py``).

A run is keyed by a digest of its program, tapes, configuration and what
was run (a cycle limit, or a name).  ``RunStore.result`` returns the
stored result of a run: a dict of numpy arrays, a ``trace`` dict of them,
and ``outputs`` (lists of ints) where the run had them.  While recording
(the store's environment variable names the file to write, as
``tests/fixtures/torch_port/make_fixtures.py`` sets it) it runs the
reference instead, keeps the result, and ``RunStore.write`` saves every
kept run at the end of the test module.
"""

import functools
import hashlib
import json
import os

import numpy as np


class RunStore:
    def __init__(self, path, env_var):
        self.path = path
        self.record = os.environ.get(env_var)
        self.kept = {}

    @staticmethod
    def key(program, tapes, what, cfg) -> str:
        h = hashlib.sha256(program.to_bytes())
        h.update(repr((tapes, what, sorted(cfg.items()))).encode())
        return h.hexdigest()[:20]

    def result(self, program, tapes, what, cfg, run):
        """The reference's result of this run: stored, or ``run()`` while
        recording."""
        key = self.key(program, tapes, what, cfg)
        if self.record:
            self.kept[key] = run()
            return self.kept[key]
        stored = self._stored()
        if f"{key}/.outputs" not in stored:
            raise KeyError(f"no stored reference run {key} in "
                           f"{self.path.name}: run make_fixtures.py")
        result, trace = {}, {}
        for name, value in stored.items():
            if not name.startswith(f"{key}/"):
                continue
            name = name[len(key) + 1:]
            if name.startswith("trace/"):
                trace[name[len("trace/"):]] = value
            elif name == ".outputs":
                outputs = json.loads(str(value))
                if outputs is not None:
                    result["outputs"] = outputs
            else:
                result[name] = value
        if trace:
            result["trace"] = trace
        return result

    @functools.lru_cache(maxsize=None)
    def _stored(self):
        with np.load(self.path) as f:
            return {k: f[k] for k in f.files}

    def write(self) -> None:
        """While recording: every kept run as named arrays ``key/name``
        (``key/trace/column``; the outputs, or null, as JSON text)."""
        if not self.record:
            return
        arrays = {}
        for key, result in self.kept.items():
            outputs = result.get("outputs")
            arrays[f"{key}/.outputs"] = np.array(json.dumps(
                None if outputs is None
                else [[int(x) for x in lane] for lane in outputs]))
            for name, value in result.items():
                if name == "trace":
                    arrays.update({f"{key}/trace/{col}": np.asarray(a)
                                   for col, a in value.items()})
                elif name != "outputs":
                    arrays[f"{key}/{name}"] = np.asarray(value)
        np.savez_compressed(self.record, **arrays)
