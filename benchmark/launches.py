"""The shapes of the program's kernel launches in the traced stretch.

While a ``Recorder`` is open, the program's Python entries of kernel 1
(``ops.pfn.pfn_two_layer``) and kernel 2 (``ops.gather.monotone_row_gather``)
are wrapped, wherever the program's modules hold them, to keep their
arguments; ``costs`` turns them into the least bytes and FLOPs of each
launch (``counts.py``).  The wrapped call is the program's own.
"""

from __future__ import annotations

import functools
import importlib
import sys

import torch

from benchmark import counts

ENTRIES = {"gather": ("pillarnext_tpu_torch.ops.gather", "monotone_row_gather"),
           "pfn": ("pillarnext_tpu_torch.ops.pfn", "pfn_two_layer")}
DEVICE_NAMES = {"gather": ("gather_grouped", "gather_chunked"), "pfn": ("pfn_two_layer_kernel",)}


class Recorder:
    def __init__(self):
        self.calls: list = []
        self._undo: list = []

    def __enter__(self):
        for kind, (module, name) in ENTRIES.items():
            orig = getattr(importlib.import_module(module), name)

            @functools.wraps(orig)
            def wrapper(*args, _orig=orig, _kind=kind, **kw):
                if args[0].is_cuda:
                    self.calls.append((_kind, args))
                return _orig(*args, **kw)

            for mod in list(sys.modules.values()):
                if getattr(mod, "__name__", "").startswith("pillarnext_tpu_torch") and getattr(mod, name, None) is orig:
                    setattr(mod, name, wrapper)
                    self._undo.append((mod, name, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo.clear()

    @torch.no_grad()
    def costs(self, kind: str) -> list:
        """(bytes, flops) of each recorded launch of ``kind``."""
        out = []
        for k, args in self.calls:
            if k != kind:
                continue
            if kind == "gather":
                table, idx = args[0], args[1]
                r = table.shape[0]
                ok = (idx >= 0) & (idx < r)
                distinct = int(torch.unique(idx[ok]).numel())
                out.append(counts.gather_cost(int(idx.numel()), distinct, table.shape[1] * table.element_size()))
            else:
                feats, slot, w0, _, w1, _, cap = args[:7]
                valid = slot < cap
                pillars = int(torch.unique(slot[valid]).numel())
                out.append(counts.pfn_cost(int(valid.sum()), pillars, feats.shape[1], w0.shape[1], w1.shape[1],
                                           feats.element_size()))
        return out
