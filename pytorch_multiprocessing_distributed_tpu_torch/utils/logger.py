"""Append-only space-separated experiment log files.

The port's copy of the JAX package's ``utils/logger.py``, byte for byte
in what it writes: ints ``:04d``, floats ``:.6f``, strings verbatim,
single spaces, one row per line (``0001 2.768622 15.934100``).
"""

from __future__ import annotations

from collections.abc import Iterable


class Logger:
    """Fixed-format append-only row logger."""

    def __init__(self, path: str, int_form: str = ":04d",
                 float_form: str = ":.6f"):
        self.path = path
        self.int_form = int_form
        self.float_form = float_form
        self.width = 0

    def __len__(self) -> int:
        try:
            return len(self.read())
        except FileNotFoundError:  # a log not written yet has no rows
            return 0

    def write(self, values) -> None:
        if not isinstance(values, Iterable) or isinstance(values,
                                                          (str, bytes)):
            values = [values]
        values = list(values)
        if self.width == 0:
            self.width = len(values)
        if self.width != len(values):
            raise ValueError("Inconsistent number of items.")
        line = ""
        for v in values:
            if isinstance(v, int):
                line += "{{{}}} ".format(self.int_form).format(v)
            elif isinstance(v, float):
                line += "{{{}}} ".format(self.float_form).format(v)
            elif isinstance(v, str):
                line += "{} ".format(v)
            else:
                raise TypeError(f"Not supported type: {type(v).__name__}")
        with open(self.path, "a") as f:
            f.write(line[:-1] + "\n")

    def read(self):
        with open(self.path, "r") as f:
            log = []
            for line in f:
                values = []
                for v in line.split(" "):
                    try:
                        v = float(v)
                    except ValueError:
                        pass
                    values.append(v)
                log.append(values)
        return log
