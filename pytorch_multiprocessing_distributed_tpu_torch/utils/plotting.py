"""End-of-run accuracy and loss curves and the event timeline (the port
of the JAX package's ``utils/plotting.py`` ``draw_plot`` and
``draw_timeline``).

Reads ``train.log`` and ``test.log`` through :class:`.logger.Logger`
and writes ``test_accuracy.png`` and ``loss.png`` with the reference's
series, labels, legends and titles. matplotlib is imported inside the
function, as in JAX, so importing this module costs nothing. On a host
without matplotlib (the GPU machines this port targets need not have
it) the same two files are drawn by :func:`_draw_png`: the two series as
lines on axes (train blue, test red), without text.
:func:`draw_timeline` always draws with that writer, without text: a
lane per event name, grouped by category, spans as bars and instants as
ticks.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

from .logger import Logger


def draw_plot(save_path: str) -> None:
    """Render the two training-curve PNGs from the epoch log files."""
    train_log = Logger(os.path.join(save_path, "train.log")).read()
    test_log = Logger(os.path.join(save_path, "test.log")).read()
    epoch, train_loss, train_acc = zip(*train_log)
    epoch, test_loss, test_acc = zip(*test_log)
    try:
        import matplotlib
    except ModuleNotFoundError:
        _draw_png(os.path.join(save_path, "test_accuracy.png"), epoch,
                  (train_acc, test_acc))
        _draw_png(os.path.join(save_path, "loss.png"), epoch,
                  (train_loss, test_loss))
        return

    matplotlib.use("Agg")  # the primary rank's epilogue on a headless host
    import matplotlib.pyplot as plt

    plt.plot(epoch, train_acc, "-b", label="train")
    plt.plot(epoch, test_acc, "-r", label="test")
    plt.xlabel("Epoch")
    plt.ylabel("accuracy")
    plt.legend(loc="lower right")
    plt.title("TEST accuracy ")
    plt.savefig(os.path.join(save_path, "test_accuracy.png"))
    plt.close()

    plt.plot(epoch, train_loss, "-b", label="train")
    plt.plot(epoch, test_loss, "-r", label="test")
    plt.xlabel("Epoch")
    plt.ylabel("loss")
    plt.legend(loc="upper right")
    plt.title("loss")
    plt.savefig(os.path.join(save_path, "loss.png"))
    plt.close()


_W, _H, _PAD = 640, 480, 40
_COLORS = ((0, 0, 255), (255, 0, 0))  # train blue, test red


class _Canvas:
    """An RGB raster on white, written as a PNG with the standard
    library alone."""

    def __init__(self, width: int, height: int):
        self.w, self.h = width, height
        self.px = bytearray(b"\xff" * (width * height * 3))

    def dot(self, x, y, color) -> None:
        if 0 <= x < self.w and 0 <= y < self.h:
            i = 3 * (y * self.w + x)
            self.px[i:i + 3] = bytes(color)

    def line(self, x0, y0, x1, y1, color) -> None:
        steps = max(abs(x1 - x0), abs(y1 - y0), 1)
        for k in range(steps + 1):
            self.dot(round(x0 + (x1 - x0) * k / steps),
                     round(y0 + (y1 - y0) * k / steps), color)

    def rect(self, x0, y0, x1, y1, color) -> None:
        for y in range(y0, y1):
            for x in range(x0, x1):
                self.dot(x, y, color)

    def write(self, path: str) -> None:
        def chunk(kind, data):
            body = kind + data
            return (struct.pack(">I", len(data)) + body
                    + struct.pack(">I", zlib.crc32(body) & 0xffffffff))

        w = self.w
        rows = b"".join(b"\x00" + bytes(self.px[3 * w * y:3 * w * (y + 1)])
                        for y in range(self.h))
        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n"
                    + chunk(b"IHDR", struct.pack(">IIBBBBB", w, self.h, 8,
                                                 2, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(rows, 6))
                    + chunk(b"IEND", b""))


def _draw_png(path: str, xs: Sequence[float],
              series: Sequence[Sequence[float]]) -> None:
    """A line plot of ``series`` over ``xs`` as an RGB PNG: axes in
    black, each series a polyline with a 5x5 marker per point, scaled to
    the data's range."""
    canvas = _Canvas(_W, _H)
    lo_x, hi_x = min(xs), max(xs)
    values = [v for s in series for v in s]
    lo_y, hi_y = min(values), max(values)

    def to_px(x, y):
        fx = 0.5 if hi_x == lo_x else (x - lo_x) / (hi_x - lo_x)
        fy = 0.5 if hi_y == lo_y else (y - lo_y) / (hi_y - lo_y)
        return (round(_PAD + fx * (_W - 2 * _PAD)),
                round(_H - _PAD - fy * (_H - 2 * _PAD)))

    black = (0, 0, 0)
    canvas.line(_PAD // 2, _H - _PAD // 2, _W - _PAD // 2, _H - _PAD // 2,
                black)
    canvas.line(_PAD // 2, _PAD // 2, _PAD // 2, _H - _PAD // 2, black)
    for ys, color in zip(series, _COLORS):
        points = [to_px(x, y) for x, y in zip(xs, ys)]
        for (x0, y0), (x1, y1) in zip(points, points[1:]):
            canvas.line(x0, y0, x1, y1, color)
        for x, y in points:
            canvas.rect(x - 2, y - 2, x + 3, y + 3, color)
    canvas.write(path)


# tab10's first colors, one per event category
_CATEGORY_COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44),
                    (214, 39, 40), (148, 103, 189), (140, 86, 75),
                    (227, 119, 194), (127, 127, 127), (188, 189, 34),
                    (23, 190, 207))
_LANE = 14


def draw_timeline(events_path: str, out_path: Optional[str] = None) -> str:
    """Render a JSONL event log (``--events_out``, or a flight dump: its
    header line is skipped) as a timeline PNG: one lane per event name,
    lanes grouped by category (one color each), spans (``ph="X"``) as
    bars from start to end, instants as ticks, time left to right from
    the first event. Returns the path written (default: the log's name
    with ``.png``)."""
    from ..runtime.scope import events_from_jsonl

    events = events_from_jsonl(events_path)
    if not events:
        raise ValueError(f"no scope events in {events_path}")
    if out_path is None:
        out_path = os.path.splitext(events_path)[0] + ".png"
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + (e.get("dur", 0.0) if e["ph"] == "X" else 0.0)
             for e in events)
    lanes = sorted({(e["cat"], e["name"]) for e in events})
    lane_of = {key: i for i, key in enumerate(lanes)}
    cats = sorted({c for c, _ in lanes})
    color_of = {c: _CATEGORY_COLORS[i % len(_CATEGORY_COLORS)]
                for i, c in enumerate(cats)}
    width = 1000
    canvas = _Canvas(width, 2 * _PAD + _LANE * len(lanes))
    span = (t1 - t0) or 1.0

    def x_of(t):
        return _PAD + round((t - t0) / span * (width - 2 * _PAD))

    for e in events:
        y = _PAD + _LANE * lane_of[(e["cat"], e["name"])]
        color = color_of[e["cat"]]
        x = x_of(e["ts"])
        if e["ph"] == "X":
            end = max(x_of(e["ts"] + e.get("dur", 0.0)), x + 1)
            canvas.rect(x, y + 2, end, y + _LANE - 2, color)
        else:
            canvas.line(x, y, x, y + _LANE - 1, color)
    canvas.line(_PAD // 2, canvas.h - _PAD // 2, width - _PAD // 2,
                canvas.h - _PAD // 2, (0, 0, 0))
    canvas.write(out_path)
    return out_path
