"""Logbook — host-side chronological record with chapters and incremental
column-aligned stream printing.

A copy of :mod:`deap_tpu.support.logbook` (numpy only), kept here so the
port never imports the JAX package. Algorithms record one entry per
generation (``record(gen=..., nevals=..., **stats)``); dict-valued
entries become chapters. :func:`logbook_from_records` builds one from
stacked per-generation records.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _scalar(x):
    """Collapse 0-d arrays to native Python scalars (so ``%g``
    formatting and JSON serialisation see floats/ints, not numpy
    types); pass everything else through unchanged."""
    a = np.asarray(x)
    if a.ndim == 0:
        return a.item()
    return a


class Logbook(list):
    def __init__(self):
        super().__init__()
        self.buffindex = 0
        self.chapters: Dict[str, "Logbook"] = {}
        self.columns_len: List[int] | None = None
        self.header: Sequence[str] | None = None
        self.log_header = True

    def record(self, **infos: Any) -> None:
        """Append one entry; dict-valued entries become chapters
        (support.py:335-349)."""
        apply_to_all = {k: v for k, v in infos.items() if not isinstance(v, dict)}
        for key, value in list(infos.items()):
            if isinstance(value, dict):
                chapter_infos = dict(value)
                chapter_infos.update(apply_to_all)
                if key not in self.chapters:
                    self.chapters[key] = Logbook()
                    self.chapters[key].columns_len = None
                self.chapters[key].record(**chapter_infos)
                del infos[key]
        self.append({k: _scalar(v) for k, v in infos.items()})

    def select(self, *names: str):
        """Columns as lists, in entry order (support.py:360-372)."""
        if len(names) == 1:
            return [entry.get(names[0], None) for entry in self]
        return tuple([entry.get(name, None) for entry in self] for name in names)

    def pop(self, index: int = 0):
        """Remove and return entry ``index``, keeping ``stream``'s
        not-yet-printed window consistent: only removing an entry that
        was *already streamed* shifts the buffer index. Negative
        indexes are normalised first — the raw comparison would treat
        ``pop(-1)`` (usually an unstreamed tail entry) as
        already-streamed and wrongly re-stream an old entry
        (support.py:351-358 has the same latent bug)."""
        if index < 0:
            index += len(self)
        if self.buffindex > index:
            self.buffindex -= 1
        return super().pop(index)

    @property
    def stream(self) -> str:
        """Text of the entries recorded since the last access, with a
        header on first use (support.py:383-399)."""
        startindex, self.buffindex = self.buffindex, len(self)
        return self.__str__(startindex)

    def _txt(self, startindex: int) -> List[List[str]]:
        columns = list(self.header) if self.header else sorted(
            self[0].keys() if self else [])
        if not self.columns_len or len(self.columns_len) != len(columns):
            self.columns_len = [len(c) for c in columns]

        chapters_txt = {}
        offsets = {}
        for name, chapter in self.chapters.items():
            chapters_txt[name] = chapter._txt(startindex)
            if startindex == 0:
                offsets[name] = len(chapters_txt[name]) - len(self)

        str_matrix = []
        for i, line in enumerate(self[startindex:], startindex):
            str_line = []
            for j, name in enumerate(columns):
                if name in chapters_txt:
                    column = chapters_txt[name][i + offsets.get(name, 0)]
                else:
                    value = line.get(name, "")
                    if isinstance(value, float):
                        column = "%g" % value
                    else:
                        column = str(value)
                self.columns_len[j] = max(self.columns_len[j], len(column))
                str_line.append(column)
            str_matrix.append(str_line)

        if startindex == 0 and self.log_header:
            header = []
            nlines = 1
            if len(self.chapters) > 0:
                nlines += max(map(len, chapters_txt.values())) - len(self) + 1
            header = [[] for _ in range(nlines)]
            for j, name in enumerate(columns):
                if name in chapters_txt:
                    length = max(len(line.expandtabs()) for line in
                                 chapters_txt[name][0].split("\n")) if chapters_txt[name] else len(name)
                    blanks = nlines - 2 - offsets.get(name, 0)
                    for i in range(blanks):
                        header[i].append(" " * length)
                    header[blanks].append(name.center(length))
                    header[blanks + 1].append("-" * length)
                    for i in range(offsets.get(name, 0)):
                        header[blanks + 2 + i].append(
                            chapters_txt[name][i])
                else:
                    length = max(len(name), self.columns_len[j])
                    for line in header[:-1]:
                        line.append(" " * length)
                    header[-1].append(name)
            str_matrix = header + str_matrix

        template = "\t".join("{%i:<%i}" % (i, l) for i, l in
                             enumerate(self.columns_len))
        text = [template.format(*line) for line in str_matrix]
        return text

    def __str__(self, startindex: int = 0) -> str:
        text = self._txt(startindex)
        return "\n".join(text)


def logbook_from_records(records, header=None) -> Logbook:
    """A Logbook from a pytree (dicts, tuples, lists) of stacked
    per-generation tensors or arrays, each leaf with leading axis
    ``ngen``: one entry a generation."""
    logbook = Logbook()
    if header:
        logbook.header = header
    leaves, spec = pytree.tree_flatten(records)
    if not leaves:
        return logbook
    leaves = [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
              else np.asarray(leaf) for leaf in leaves]
    for i in range(leaves[0].shape[0]):
        logbook.record(**pytree.tree_unflatten([l[i] for l in leaves], spec))
    return logbook
