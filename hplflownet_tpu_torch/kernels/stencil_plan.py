"""Stencil plans: the row order and per-tap vertex lists the stencil kernels walk.

A neighbour table ``nb`` (F, H_out) of the lattice stencil marks tap f of
vertex v present where ``0 <= nb[f, v] < h_in``.  Most (vertex, tap) pairs
are absent (60% of them in the flagship's scale-0 blur), and in the
table's natural order nearly every 128-row block holds every tap somewhere.
A plan, made once per table and pair, lets the kernels skip that work:

* ``order`` (H_out,): the output rows stably sorted by their tap-presence
  mask, so that the rows of one 128-row block share their absent taps.
  ``stencil_gather_matmul`` walks its output rows in this order, reads
  ``nb[f, order[i]]`` and writes row ``order[i]``; a (block, tap) pair with
  no present row is skipped.  Unoccupied rows (mask 0) sort to the front
  and still get ``act(bias)``.  A mask wider than one word (the 65 taps of
  ``corr_cross``) is sorted word by word, least significant first, with
  stable sorts: the lexicographic order of the words.
* ``verts`` / ``rows`` (F, H_out) and ``counts`` (F,): per tap, its present
  vertices in increasing order and the table rows they read
  (``rows[f, i] = nb[f, verts[f, i]]``), -1 past ``counts[f]``.
  ``stencil_dkernel`` sums over exactly these, in this fixed order.

Negating the taps (the input gradient's table ``nb[tap_negation]``) only
relabels them, so the forward's ``order`` serves it too: every block keeps
its number of present taps.

The plan is plain PyTorch on the table's device: static shapes, no host
synchronisation.  ``make_stencil_plans`` plans all of a pair's tables at
once, one sort per tap count (83 CUDA kernels for the flagship pair's 24
plans, 163 with the lists, against ~17 and ~35 per table planned alone;
H100, 700 W, ``chip_smoke.py``), since the forward and step are bound by
the host's launches.  A forward that takes no gradient needs ``order``
only (``lists=False`` leaves the other fields None).
``make_stencil_plan.builds`` counts the plans made.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import device_constant

__all__ = ["StencilPlan", "ROW_BLOCK", "presence", "make_stencil_plan",
           "make_stencil_plans", "block_tap_counts"]

ROW_BLOCK = 128   # output rows per block of stencil_gather_matmul's bf16 kernel
# sort-key words: taps per word and its dtype; the narrowest that holds
# every tap, so a radix sort makes fewer passes (a 15-tap mask: int16)
_WORDS = ((15, torch.int16, np.int16), (31, torch.int32, np.int32),
          (62, torch.int64, np.int64))


class StencilPlan(NamedTuple):
    order: torch.Tensor           # (H_out,) int32 rows, stably sorted by mask
    verts: torch.Tensor | None    # (F, H_out) int32 present vertices, -1 after
    rows: torch.Tensor | None     # (F, H_out) int32 nb[f, verts[f, i]], -1 after
    counts: torch.Tensor | None   # (F,) int32 present vertices per tap
    # verts and rows are contiguous along H_out; their row stride may be
    # wider (plans made together are slices of one group's tensors)


def presence(neighbors: torch.Tensor, h_in) -> torch.Tensor:
    """(F, H_out) bool: tap f of vertex v reads a table row (``h_in`` an int
    or a (H_out,) tensor of each column's table size)."""
    return (neighbors >= 0) & (neighbors < h_in)


def _key_words(bits: torch.Tensor) -> list:
    """Sort keys of the columns of ``bits`` (B, H) bool, least significant
    word first, each word in the narrowest dtype that holds it."""
    b = bits.shape[0]
    width, dt, npdt = next((w for w in _WORDS if b <= w[0]), _WORDS[-1])
    keys = []
    for lo in range(0, b, width):
        n = min(width, b - lo)
        weights = device_constant(np.left_shift(1, np.arange(n, dtype=npdt)),
                                  bits.device)
        keys.append(torch.where(bits[lo:lo + n], weights[:, None], 0)
                    .sum(0, dtype=dt))
    return keys


def _sort_columns(bits: torch.Tensor) -> torch.Tensor:
    """(H,) int64: the columns of ``bits`` stably sorted by their bits read
    as one integer (word by word, least significant first)."""
    order = None
    for key in _key_words(bits):
        if order is None:
            order = torch.sort(key, stable=True).indices
        else:
            order = order[torch.sort(key[order], stable=True).indices]
    return order


_GROUP_CONSTANTS: dict = {}


def _group_constants(widths, h_ins, device) -> dict:
    """The per-column constants of a group of tables (widths and table
    sizes), made on the device once: the key is a few ints, not the
    arrays' bytes."""
    key = (tuple(widths), tuple(h_ins), str(torch.device(device)))
    c = _GROUP_CONSTANTS.get(key)
    if c is None:
        t = len(widths)
        seg = np.repeat(np.arange(t), widths)
        offs = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int64)
        nbits = max(0, (t - 1).bit_length())
        host = dict(
            h_in=np.repeat(np.asarray(h_ins, np.int32), widths),
            seg=seg.astype(np.int64),
            seg_bits=(seg[None, :] >> np.arange(nbits)[:, None]) & 1 > 0,
            offset=offs[seg],
            seg_key=(2 * seg).astype(np.int32),
            ends=np.cumsum(widths).astype(np.int64) - 1,
            slot=np.arange(len(seg), dtype=np.int32) - offs[seg].astype(np.int32))
        c = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in host.items()}
        _GROUP_CONSTANTS[key] = c
    return c


def _plan_group(tables, lists: bool) -> list:
    """Plans of tables that share their tap count, from one concatenated
    problem: the columns of all tables sort together, with the table's
    index above the mask bits, so each table's rows stay in its own slice."""
    dev = tables[0][0].device
    widths = [nb.shape[1] for nb, _ in tables]
    offs = np.concatenate([[0], np.cumsum(widths)[:-1]])
    c = _group_constants(widths, [h for _, h in tables], dev)
    nb = torch.cat([nb for nb, _ in tables], 1) if len(tables) > 1 else tables[0][0]
    present = presence(nb, c["h_in"])
    bits = torch.cat([present, c["seg_bits"]]) if len(c["seg_bits"]) else present
    order = (_sort_columns(bits) - c["offset"]).to(torch.int32)
    if not lists:
        return [StencilPlan(order=order[o:o + w], verts=None, rows=None,
                            counts=None) for o, w in zip(offs, widths)]
    # per tap, each table's present vertices first, each group in vertex
    # order: one segmented sort of (table, absent) over the concatenation
    key = torch.logical_not(present).to(torch.int32) + c["seg_key"]
    first = torch.sort(key, dim=1, stable=True).indices       # (F, sum H)
    total = torch.cumsum(present, 1, dtype=torch.int32)[:, c["ends"]]  # (F, T)
    counts = torch.diff(total, dim=1, prepend=total.new_zeros(total.shape[0], 1))
    keep = c["slot"][None, :] < counts[:, c["seg"]]
    verts = torch.where(keep, (first - c["offset"]).to(torch.int32), -1)
    rows = torch.where(keep, torch.gather(nb, 1, first), -1)
    counts = counts.t().contiguous()                           # (T, F)
    return [StencilPlan(order=order[o:o + w], verts=verts[:, o:o + w],
                        rows=rows[:, o:o + w], counts=counts[i])
            for i, (o, w) in enumerate(zip(offs, widths))]


def make_stencil_plans(tables, lists: bool = True) -> list:
    """The plans of several (neighbour table, table rows) pairs at once.

    Tables with the same tap count are planned together in one
    concatenated sort, so a pair's plans cost a few dozen launches, not a
    few hundred; a table's ``verts`` and ``rows`` are then column slices of
    the group's (row stride = the group's total width).  With
    ``lists=False`` only the row orders (what the forward kernel reads).
    """
    make_stencil_plan.builds += len(tables)
    plans = [None] * len(tables)
    groups: dict = {}
    for i, (nb, _) in enumerate(tables):
        groups.setdefault(nb.shape[0], []).append(i)
    for idx in groups.values():
        for i, plan in zip(idx, _plan_group([tables[i] for i in idx], lists)):
            plans[i] = plan
    return plans


def make_stencil_plan(neighbors: torch.Tensor,   # (F, H_out) int32
                      h_in: int, lists: bool = True) -> StencilPlan:
    """The plan of one neighbour table over a table of ``h_in`` rows; with
    ``lists=False`` the row order alone (what the forward kernel reads)."""
    return make_stencil_plans([(neighbors, h_in)], lists)[0]


make_stencil_plan.builds = 0


def block_tap_counts(present: torch.Tensor, order: torch.Tensor,
                     block: int = ROW_BLOCK) -> torch.Tensor:
    """(ceil(H_out / block),) int: the taps present somewhere in each block
    of ``block`` rows taken in ``order`` -- the taps a block computes."""
    f, h = present.shape
    nblk = -(-h // block)
    p = present[:, order.long()]
    p = torch.cat([p, p.new_zeros(f, nblk * block - h)], 1)
    return p.view(f, nblk, block).any(2).sum(0)
