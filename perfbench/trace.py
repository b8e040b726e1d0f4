"""The traced run: spans around the program's layer entry points, one
``torch.profiler`` window, and the reading of its trace.

The program is not edited. In the traced run only, the entry points that
``mwm_pipeline`` reaches are replaced, for the length of the run, by
wrappers that synchronise the device at both edges and open a
``record_function`` range, so the spans and the device's operations lie
on one clock in one trace. An entry point that is gone is reported, and
the metrics that read its span find nothing.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import tempfile

import torch

PREFIX = "perfbench/"
#: span name -> (module, attribute) of the entry point it wraps
ENTRY_POINTS = {
    "mwm_pipeline": ("repro_torch.core", "mwm_pipeline"),
    "mwm_blocked": ("repro_torch.core", "mwm_blocked"),
    "substream_match": ("repro_torch.kernels.substream_match.ops", "substream_match"),
}
#: trace categories of the device's own operations
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync(device: str):
    if device == "cuda":
        torch.cuda.synchronize()


def span(name: str):
    """A host range the trace records under ``perfbench/<name>``."""
    return torch.profiler.record_function(PREFIX + name)


def _wrapper(fn, name: str, device: str):
    def wrapped(*args, **kwargs):
        _sync(device)
        with span(name):
            out = fn(*args, **kwargs)
            _sync(device)
        return out

    wrapped.__wrapped__ = fn
    return wrapped


@contextlib.contextmanager
def entry_spans(device: str):
    """Wrap every entry point of :data:`ENTRY_POINTS` that exists, for the
    length of the block; name on stderr those that do not."""
    missing, undo = [], []
    for name, (mod_name, attr) in ENTRY_POINTS.items():
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            missing.append(name)
            continue
        fn = getattr(mod, attr, None)
        if fn is None:
            missing.append(name)
            continue
        setattr(mod, attr, _wrapper(fn, name, device))
        undo.append((mod, attr, fn))
    for name in missing:
        print(f"perfbench: entry point {name} not found; its span is not recorded",
              file=sys.stderr)
    try:
        yield
    finally:
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def profiled(device: str):
    """One profiler window; yields a dict that holds, once the window has
    closed, the parsed trace (:func:`parse`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    box = {}
    with torch.profiler.profile(activities=activities) as prof:
        yield box
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            box.update(parse(json.load(f)))


def parse(chrome: dict) -> dict:
    """The benchmark's spans and the device's operations of a Chrome trace,
    in seconds on the trace's clock: ``spans`` [(name, start, end)],
    ``device`` [(name, start, end)]."""
    events = chrome.get("traceEvents", chrome) if isinstance(chrome, dict) else chrome
    spans, device = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        a = float(ev["ts"]) * 1e-6
        b = a + float(ev["dur"]) * 1e-6
        name = ev.get("name", "")
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((name, a, b))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], a, b))
    return {"spans": spans, "device": device}
