"""Console progress reporting for the long-running CLIs.

Port of the JAX package's ``utils/progress.py`` (pure Python, copied): a
throttled, ETA-estimating :class:`Bar` with an iterator wrapper, and a
:func:`progress_bar` functional form for index-driven loops.  TTY streams
get an in-place ``\\r`` bar; other streams (log files, CI) one line per
~10%, so logs stay readable.
"""

from __future__ import annotations

import sys
import time


def format_eta(seconds: float) -> str:
    """Compact duration: ``45s``, ``3m20s``, ``1h02m``, ``2d03h``."""
    s = max(0, int(seconds + 0.5))
    if s < 60:
        return f"{s}s"
    m, s = divmod(s, 60)
    if m < 60:
        return f"{m}m{s:02d}s"
    h, m = divmod(m, 60)
    if h < 24:
        return f"{h}h{m:02d}m"
    d, h = divmod(h, 24)
    return f"{d}d{h:02d}h"


class Bar:
    """Incremental progress bar with rate + ETA.

    >>> bar = Bar(100, desc="feats")
    >>> for item in work: bar.update()
    >>> bar.close()

    or ``for item in Bar.wrap(work, desc="feats"): ...``.
    """

    def __init__(self, total, desc: str = "", width: int = 30,
                 stream=None, min_interval: float = 0.25):
        self.total = int(total) if total else 0
        self.desc = desc
        self.width = width
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = min_interval
        self.count = 0
        self.suffix = ""
        self._start = time.monotonic()
        self._last_draw = 0.0
        self._last_nontty_decile = -1
        self._closed = False
        self._isatty = bool(getattr(self.stream, "isatty", lambda: False)())

    @classmethod
    def wrap(cls, iterable, desc: str = "", total=None, **kw):
        """Yield from ``iterable`` while advancing a bar (closes it after)."""
        if total is None:
            try:
                total = len(iterable)
            except TypeError:
                total = 0
        bar = cls(total, desc=desc, **kw)
        try:
            for item in iterable:
                yield item
                bar.update()
        finally:
            bar.close()

    def set_suffix(self, msg: str):
        self.suffix = msg

    def update(self, n: int = 1):
        self.count += n
        now = time.monotonic()
        finished = bool(self.total) and self.count >= self.total
        if self._isatty:
            if finished or now - self._last_draw >= self.min_interval:
                self._last_draw = now
                self._draw(end="\r")
        elif self.total:
            # one line per decile (plus the final one) on non-TTY streams
            decile = 10 * self.count // self.total
            if decile != self._last_nontty_decile or finished:
                self._last_nontty_decile = decile
                self._draw(end="\n")
        else:
            # unknown total on non-TTY: time-throttled lines, never per-item
            if now - self._last_draw >= max(self.min_interval, 2.0):
                self._last_draw = now
                self._draw(end="\n")

    def _draw(self, end: str):
        elapsed = time.monotonic() - self._start
        rate = self.count / elapsed if elapsed > 0 else 0.0
        if self.total:
            frac = min(1.0, self.count / self.total)
            filled = int(self.width * frac)
            arrow = ">" if filled < self.width else "="
            bar = "=" * filled + arrow + "." * (self.width - filled - 1)
            eta = format_eta((self.total - self.count) / rate) if rate > 0 else "?"
            line = (f"{self.desc} [{bar}] {self.count}/{self.total} "
                    f"{100 * frac:3.0f}% | {rate:.1f}/s | eta {eta}")
        else:
            line = f"{self.desc} {self.count} | {rate:.1f}/s"
        if self.suffix:
            line += f" | {self.suffix}"
        self.stream.write(line + end)
        try:
            self.stream.flush()
        except Exception:
            pass

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._isatty or not self.total:
            self._draw(end="\n")  # final count always lands in the output

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_FUNC_BARS: dict = {}


def progress_bar(current: int, total: int, msg: str = None,
                 desc: str = "", stream=None):
    """Index-driven form for ``for i in range(n): progress_bar(i, n)`` loops
    (the shape the reference's ``misc.progress_bar`` serves).  A new bar
    starts whenever ``current == 0``; the bar closes at ``current == total-1``.
    """
    key = (desc, id(stream) if stream is not None else 0)
    bar = _FUNC_BARS.get(key)
    if current == 0 or bar is None or bar.total != total:
        bar = Bar(total, desc=desc, stream=stream)
        _FUNC_BARS[key] = bar
    if msg:
        bar.set_suffix(msg)
    bar.count = current  # caller owns the index
    bar.update(1)
    if bar.count >= total:
        bar.close()
        _FUNC_BARS.pop(key, None)
