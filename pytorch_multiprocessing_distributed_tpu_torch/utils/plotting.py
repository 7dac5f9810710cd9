"""End-of-run accuracy and loss curves (the port of the JAX package's
``utils/plotting.py`` ``draw_plot``).

Reads ``train.log`` and ``test.log`` through :class:`.logger.Logger`
and writes ``test_accuracy.png`` and ``loss.png`` with the reference's
series, labels, legends and titles. matplotlib is imported inside the
function, as in JAX, so importing this module costs nothing. On a host
without matplotlib (the GPU machines this port targets need not have
it) the same two files are drawn by :func:`_draw_png`: the two series as
lines on axes (train blue, test red), without text.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

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


def _draw_png(path: str, xs: Sequence[float],
              series: Sequence[Sequence[float]]) -> None:
    """A line plot of ``series`` over ``xs`` as an RGB PNG, written with
    the standard library alone: axes in black, each series a polyline
    with a 5x5 marker per point, scaled to the data's range."""
    px = bytearray(b"\xff" * (_W * _H * 3))

    def dot(x, y, color):
        if 0 <= x < _W and 0 <= y < _H:
            i = 3 * (y * _W + x)
            px[i:i + 3] = bytes(color)

    def line(x0, y0, x1, y1, color):
        steps = max(abs(x1 - x0), abs(y1 - y0), 1)
        for k in range(steps + 1):
            dot(round(x0 + (x1 - x0) * k / steps),
                round(y0 + (y1 - y0) * k / steps), color)

    lo_x, hi_x = min(xs), max(xs)
    values = [v for s in series for v in s]
    lo_y, hi_y = min(values), max(values)

    def to_px(x, y):
        fx = 0.5 if hi_x == lo_x else (x - lo_x) / (hi_x - lo_x)
        fy = 0.5 if hi_y == lo_y else (y - lo_y) / (hi_y - lo_y)
        return (round(_PAD + fx * (_W - 2 * _PAD)),
                round(_H - _PAD - fy * (_H - 2 * _PAD)))

    black = (0, 0, 0)
    line(_PAD // 2, _H - _PAD // 2, _W - _PAD // 2, _H - _PAD // 2, black)
    line(_PAD // 2, _PAD // 2, _PAD // 2, _H - _PAD // 2, black)
    for ys, color in zip(series, _COLORS):
        points = [to_px(x, y) for x, y in zip(xs, ys)]
        for (x0, y0), (x1, y1) in zip(points, points[1:]):
            line(x0, y0, x1, y1, color)
        for x, y in points:
            for dx in range(-2, 3):
                for dy in range(-2, 3):
                    dot(x + dx, y + dy, color)

    def chunk(kind, data):
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xffffffff))

    rows = b"".join(b"\x00" + bytes(px[3 * _W * y:3 * _W * (y + 1)])
                    for y in range(_H))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", _W, _H, 8, 2, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(rows, 6))
                + chunk(b"IEND", b""))
