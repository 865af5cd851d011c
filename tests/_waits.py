"""Time limits for the port's tests that wait on a process, a socket or a
thread: each wait has a limit of its own, and a test whose child does not
finish in time fails with the child's output instead of hanging the run
(pytest-timeout is not installed)."""

from __future__ import annotations

import subprocess
import threading
import time


def communicate_all(procs, timeout: float) -> list:
    """Each process's combined output, within ``timeout`` seconds for all
    of them together; on the limit every process still running is killed
    and an ``AssertionError`` carries every process's output."""
    deadline = time.time() + timeout
    outs, late = [], []
    try:
        for i, p in enumerate(procs):
            try:
                out = p.communicate(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                late.append(i)
                p.kill()
                out = p.communicate()
            outs.append((out[0] or b"").decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if late:
        raise AssertionError(
            f"process(es) {late} did not exit within {timeout} s:\n"
            + "\n".join(f"--- process {i} ---\n{o[-3000:]}"
                        for i, o in enumerate(outs)))
    return outs


def run(cmd, timeout: float, **kwargs) -> subprocess.CompletedProcess:
    """``subprocess.run`` with captured text output; on the limit it fails
    with what the child had printed."""
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, **kwargs)
    except subprocess.TimeoutExpired as e:
        def text(b):
            return b.decode(errors="replace") if isinstance(b, bytes) else b or ""
        raise AssertionError(f"{cmd[:4]} did not exit within {timeout} s:\n"
                             f"{text(e.stdout)[-3000:]}\n"
                             f"{text(e.stderr)[-3000:]}") from None


def call_in_thread(fn, timeout: float, what: str):
    """``fn()`` in a daemon thread; its result, its exception raised here,
    or an ``AssertionError`` when it has not returned within ``timeout``
    seconds (its output is in the test's captured output)."""
    box = {}

    def target():
        try:
            box["result"] = fn()
        except BaseException as e:      # re-raised in the test's thread
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise AssertionError(f"{what} did not return within {timeout} s")
    if "error" in box:
        raise box["error"]
    return box["result"]
