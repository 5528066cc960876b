"""Lattice pyramid construction on the device with static shapes.

Port of ``hplflownet_tpu/lattice/build.py`` (forward path).  Each cloud's
lattice keys are packed into int32 words, sorted once, and deduplicated into
a static-``capacity`` vertex table whose ids are ranks in sorted-key order;
every lookup (blur neighbors, correlation tables) is an exact sort-merge
join: ``torch.searchsorted`` of the query keys in the sorted vertex table.

The port is window-free: the JAX package's windowed probes and Pallas
windows exist for the TPU and degrade out-of-window work to "absent"; here
every probe is exact, so ``probe_overflow`` and ``stencil_overflow`` are
always zero and the tables equal the JAX package's under
``hplflownet_tpu.ops.dispatch.exact_mode``.  Capacity and key-range overflow
are still dropped and counted per cloud, as there.

Index tables are stencil-major — ``(F, H)``, ``(Cc, H)``, ``(U, H)`` — as
in the JAX package, so they compare one for one.  Nothing here reads a
device tensor back to the host: counts stay 0-dim tensors.

``HPL_FUSED_BUILD`` (read at each :func:`build_pyramid` call, as in the
JAX package; off by default) builds both clouds of a scale from one
tagged sort and probes both tables in one join
(:func:`_build_two_from_elevated`, :func:`_probe_two`): the same tables,
bit for bit, from about a third fewer operators.

:func:`build_scales` is the one-cloud build of a multi-lattice model
(SPLATNet3D): every scale elevated from the same points, each with its
blur table, and no second cloud.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import device_constant, scalar
from ..ops.segment import ReducePlan, local_ranks
from ..ops.shard import axis_shard, gather_parts, local_part
from ..utils.profiling import count, span
from .geometry import elevate, simplex_from_elevated
from .offsets import neighborhood_offsets

__all__ = ["probe_sharding", "ScaleSpec", "LatticeSpec", "CloudLattice",
           "ScalePair", "CloudScale", "build_pyramid", "build_scales",
           "default_capacities"]

_DELTA_MARGIN = 16   # headroom for stencil deltas (|combined offset| <= 8)
_SENTINEL = int(np.iinfo(np.int32).max)
_SENT_LO = (1 << 30) - 1
# the fused two-cloud joins and sort tag cloud 2's keys with bit 62 of the
# int64 key (_key64 fills bits 0-61): every key of cloud 1, its sentinels
# included, then sorts before every key of cloud 2
_TAG = 1 << 62
_I32 = torch.int32


class ScaleSpec(NamedTuple):
    """One row of ``scales_filter_map`` plus a static vertex capacity."""

    scale: float
    blur_radius: int          # -1 => no blur tables at this scale
    corr_filter_radius: int   # -1 => no correlation at this scale
    corr_corr_radius: int
    capacity: int             # static max #lattice vertices per cloud


class LatticeSpec(NamedTuple):
    d: int
    scales: tuple             # tuple[ScaleSpec, ...]
    coord_bits: int = 10      # bits per packed key coordinate (10: one word)

    @property
    def d1(self) -> int:
        return self.d + 1


class CloudLattice(NamedTuple):
    """Per-cloud, per-scale lattice assignment (all static shapes)."""

    lattice_offset: torch.Tensor  # (N, d1) int32 dense vertex id; -1 absent
    barycentric: torch.Tensor     # (N, d1) float32, zero rows for invalid points
    el_minus_gr: torch.Tensor     # (N, d1) float32
    vkeys: tuple                  # 1-2 (H,) int32 sorted packed key words
    vertex_valid: torch.Tensor    # (H,) bool
    num_valid: torch.Tensor       # () int32
    overflow: torch.Tensor        # () int32 unique keys dropped past capacity
    splat_plan: ReducePlan        # rank-mode plan over lattice_offset


class ScalePair(NamedTuple):
    """Everything both clouds need at one scale (the JAX package's 20 fields)."""

    pc1_barycentric: torch.Tensor     # (N1, d1) f32
    pc2_barycentric: torch.Tensor     # (N2, d1) f32
    pc1_el_minus_gr: torch.Tensor     # (N1, d1) f32
    pc2_el_minus_gr: torch.Tensor     # (N2, d1) f32
    pc1_lattice_offset: torch.Tensor  # (N1, d1) i32
    pc2_lattice_offset: torch.Tensor  # (N2, d1) i32
    pc1_blur_neighbors: torch.Tensor  # (F, H1) i32 or (1, 1) when blur disabled
    pc2_blur_neighbors: torch.Tensor  # (F, H2) i32
    pc1_corr_indices: torch.Tensor    # (Cc, H1) i32 or (1, 1)
    pc2_corr_uniq: torch.Tensor       # (U, H1) i32 or (1, 1): unique-offset form
    pc2_corr_inverse: torch.Tensor    # (F, Cc) i32 -> u, or (1, 1)
    pc1_num_valid: torch.Tensor       # () i32
    pc2_num_valid: torch.Tensor       # () i32
    pc1_overflow: torch.Tensor        # () i32
    pc2_overflow: torch.Tensor        # () i32
    pc1_splat_plan: ReducePlan
    pc2_splat_plan: ReducePlan
    pc2_corr_uniq_inv: torch.Tensor   # (U, H2) i32 adjoint map, or (1, 1)
    probe_overflow: torch.Tensor      # () i32, always 0 (exact probes)
    stencil_overflow: torch.Tensor    # () i32, always 0 (window-free kernels)


class CloudScale(NamedTuple):
    """One cloud's lattice at one scale and its blur table
    (:func:`build_scales`)."""

    cloud: CloudLattice
    blur_neighbors: torch.Tensor      # (F, H) i32


# ---------------------------------------------------------------------------
# key packing
# ---------------------------------------------------------------------------

def _word_layout(d: int, bits: int):
    """Per-word coordinate counts; one word when all d coords fit 30 bits."""
    if d not in (2, 3, 4):
        raise NotImplementedError(f"key packing for d={d}")
    if d * bits <= 30:
        return (d,)
    return {2: (1, 1), 3: (1, 2), 4: (2, 2)}[d]


def _pack_keys(keys: torch.Tensor, d: int, bits: int) -> tuple:
    """(..., d1) int32 keys -> tuple of lexicographically ordered int32 words.

    The last coordinate is redundant (keys sum to 0) and dropped.
    """
    bias = 1 << (bits - 1)
    words, i = [], 0
    for cnt in _word_layout(d, bits):
        w = keys[..., i] + bias
        for j in range(1, cnt):
            w = (w << bits) | (keys[..., i + j] + bias)
        words.append(w.to(_I32))
        i += cnt
    return tuple(words)


def _pack_deltas(offsets: np.ndarray, d: int, bits: int, device) -> tuple:
    """Packed stencil deltas: packed(key) + delta == packed(key + offset)."""
    offsets = offsets.astype(np.int64)
    words, i = [], 0
    for cnt in _word_layout(d, bits):
        w = offsets[..., i]
        for j in range(1, cnt):
            w = (w << bits) + offsets[..., i + j]
        words.append(device_constant(w.astype(np.int32), device))
        i += cnt
    return tuple(words)


def _unpack_keys(words, d: int, bits: int) -> torch.Tensor:
    """Inverse of :func:`_pack_keys`; reconstructs the dropped last coord."""
    bias = 1 << (bits - 1)
    mask = (1 << bits) - 1
    coords = []
    for w, cnt in zip(words, _word_layout(d, bits)):
        for j in range(cnt - 1, -1, -1):
            coords.append(((w >> (bits * j)) & mask) - bias)
    total = coords[0]
    for c in coords[1:]:
        total = total + c
    coords.append(-total)
    return torch.stack(coords, dim=-1)


def _key64(words) -> torch.Tensor:
    """One int64 per key with the words' lexicographic order (words >= 0)."""
    k = words[0].to(torch.int64)
    for w in words[1:]:
        k = (k << 31) | w.to(torch.int64)
    return k


def _offset_queries(offsets: np.ndarray, vkeys, ok: torch.Tensor, d, bits):
    """Packed ``vkeys + offset`` per (offset, vertex); sentinel where not ok."""
    deltas = _pack_deltas(offsets, d, bits, vkeys[0].device)
    return tuple(
        torch.where(ok, dv[:, None] + torch.where(ok, v[None, :], 0), _SENTINEL)
        for dv, v in zip(deltas, vkeys))


# Call-time hook: when set, the stencil probes (queries of shape (taps, H))
# are split over the taps of a mesh axis: each rank probes its taps'
# queries against the whole, replicated key table, and an all-gather puts
# the taps back together.  The probes are the pyramid's largest work and
# are independent across taps (JAX: a shard_map over the tap axis).
_PROBE_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "probe_shard", default=None)


@contextlib.contextmanager
def probe_sharding(mesh, axis: str = "lattice"):
    """Split the stencil probes of the enclosed builds over ``mesh``'s
    ``axis`` (a ``parallel.Mesh``); every rank of the axis must build the
    same pyramid.  Without a process group, or with one rank on the axis,
    the probes run whole."""
    token = _PROBE_SHARD.set(axis_shard(mesh, axis))
    try:
        yield
    finally:
        _PROBE_SHARD.reset(token)


def _probe(vkeys, qwords):
    """Exact sort-merge join of query keys against a sorted vertex table.

    Returns ``(idx, found)`` shaped like the queries: ``idx`` counts table
    keys strictly below the query (the dense vertex id where ``found``).
    Under :func:`probe_sharding`, (taps, H) queries are split over the
    taps, padded with sentinel queries (which sort last and match nothing
    real) to a multiple of the rank count.
    """
    shard = _PROBE_SHARD.get()
    if shard is None or qwords[0].dim() != 2:
        return _probe_local(vkeys, qwords)
    f = qwords[0].shape[0]
    idx, found = _probe_local(vkeys, tuple(local_part(q, 0, _SENTINEL, shard)
                                           for q in qwords))
    both = gather_parts(torch.stack([idx, found.to(_I32)], dim=1), f, shard)
    return both[:, 0], both[:, 1].bool()


def _probe_local(vkeys, qwords):
    q = _key64(qwords)
    idx, found = _search(_key64(vkeys), q.reshape(-1))
    return idx.reshape(q.shape), found.reshape(q.shape)


def _search(table: torch.Tensor, q: torch.Tensor):
    """(idx, found) of int64 keys ``q`` in the sorted int64 ``table``."""
    n_t = table.shape[0]
    idx = torch.searchsorted(table, q, side="left", out_int32=True)
    found = table[idx.clamp(max=n_t - 1).long()] == q
    return idx, found & (idx < n_t)


def _probe_two(vkeys_a, qa, vkeys_b, qb):
    """Both clouds' probes as one join over the tagged table ``[a | b]``
    -> ``(idx_a, found_a, idx_b, found_b)``, each as :func:`_probe` gives
    it where found (b's indices rebased to its own table).  Under
    :func:`probe_sharding` the two probes run apart, split over the taps."""
    if _PROBE_SHARD.get() is not None:
        return (*_probe(vkeys_a, qa), *_probe(vkeys_b, qb))
    na, ha = qa[0].numel(), vkeys_a[0].shape[0]
    idx, found = _search(
        torch.cat([_key64(vkeys_a), _key64(vkeys_b) | _TAG]),
        torch.cat([_key64(qa).reshape(-1), _key64(qb).reshape(-1) | _TAG]))
    return (idx[:na].reshape(qa[0].shape), found[:na].reshape(qa[0].shape),
            (idx[na:] - ha).reshape(qb[0].shape),
            found[na:].reshape(qb[0].shape))


# ---------------------------------------------------------------------------
# per-cloud build
# ---------------------------------------------------------------------------

def _build_from_elevated(elevated: torch.Tensor, valid: torch.Tensor,
                         capacity: int, bits: int = 10) -> CloudLattice:
    """Build the dense-id vertex table from (N, d1) elevated coordinates."""
    dev = elevated.device
    n, d1 = elevated.shape
    d = d1 - 1
    kb = simplex_from_elevated(elevated)

    # key coordinates that do not fit the packed fields (with the stencil
    # delta margin) degrade their point to invalid and are counted
    bound = (1 << (bits - 1)) - 1 - _DELTA_MARGIN
    in_range = (kb.keys.abs() <= bound).reshape(n, -1).all(dim=1)
    range_dropped = (valid & ~in_range).sum()
    valid = valid & in_range

    words = _pack_keys(kb.keys, d, bits)                      # (N, d1) each
    words = tuple(torch.where(valid[:, None], w, _SENTINEL) for w in words)
    flat = tuple(w.reshape(-1) for w in words)
    m = flat[0].shape[0]

    skey, perm = torch.sort(_key64(flat), stable=True)
    perm = perm.to(_I32)
    sw = tuple(w[perm.long()] for w in flat)
    real = (sw[0] & _SENT_LO) != _SENT_LO
    diff = skey[1:] != skey[:-1]
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), diff]) & real

    num_unique = is_new.sum(dtype=torch.int32)
    overflow = (num_unique - capacity).clamp(min=0) + range_dropped
    total_real = real.sum(dtype=torch.int32)

    # dense ids are run ranks in sorted order; rank q's run starts at the
    # first sorted position whose rank reaches q
    ranks = torch.cumsum(is_new.to(_I32), dim=0, dtype=_I32) - 1
    q = torch.arange(capacity + 1, dtype=_I32, device=dev)
    starts = torch.searchsorted(ranks, q, side="left", out_int32=True)

    rank_idx = q[:capacity]
    rank_live = rank_idx < num_unique
    vertex_start = torch.where(rank_live, starts[:capacity], total_real)
    vertex_end = torch.where(rank_idx + 1 < num_unique, starts[1:], total_real)
    vertex_end = torch.where(rank_live, vertex_end, vertex_start)
    vertex_valid = vertex_start < vertex_end

    safe_pos = starts[:capacity].clamp(max=m - 1).long()
    vkeys = tuple(torch.where(vertex_valid, w[safe_pos], _SENTINEL) for w in sw)

    # per-entry ids: the sorted ranks written back through the permutation
    # (a permutation write, so deterministic)
    ids_sorted = torch.where(real & (ranks < capacity), ranks, -1)
    ids_flat = torch.empty_like(ids_sorted)
    ids_flat[perm.long()] = ids_sorted
    lattice_offset = ids_flat.reshape(n, d1)

    barycentric = torch.where(valid[:, None], kb.barycentric, 0.0)
    el_minus_gr = torch.where(valid[:, None], kb.el_minus_gr, 0.0)

    same_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), ~diff])
    splat_plan = ReducePlan(ids=lattice_offset.reshape(-1), perm=perm,
                            start=vertex_start, end=vertex_end,
                            lrank=local_ranks(same_prev), r0=ranks[::128])
    return CloudLattice(
        lattice_offset=lattice_offset,
        barycentric=barycentric,
        el_minus_gr=el_minus_gr,
        vkeys=vkeys,
        vertex_valid=vertex_valid,
        num_valid=num_unique.clamp(max=capacity).to(_I32),
        overflow=overflow.to(_I32),
        splat_plan=splat_plan,
    )


def _build_two_from_elevated(elev1: torch.Tensor, valid1: torch.Tensor,
                             elev2: torch.Tensor, valid2: torch.Tensor,
                             capacity: int, bits: int = 10) -> tuple:
    """Both clouds' lattices from one tagged sort: field for field the two
    :func:`_build_from_elevated` calls, splat plans included.

    The tag (``_TAG``) puts every key of cloud 1 before every key of cloud
    2, so one stable sort of the 2m keys gives ``[cloud 1 sorted | cloud 2
    sorted]``, each cloud's sentinels last in its half and its equal keys
    in their standalone order.  Every per-cloud quantity is then a row of a
    (2, ...) tensor, computed for both clouds at once; cloud 2's ranks are
    the global ones less cloud 1's unique count, which stays on the device.
    """
    assert elev1.shape == elev2.shape, (elev1.shape, elev2.shape)
    dev = elev1.device
    n, d1 = elev1.shape
    d = d1 - 1
    m = n * d1
    kb = simplex_from_elevated(torch.cat([elev1, elev2]))

    bound = (1 << (bits - 1)) - 1 - _DELTA_MARGIN
    in_range = (kb.keys.abs() <= bound).reshape(2 * n, -1).all(dim=1)
    valid = torch.cat([valid1, valid2])
    range_dropped = (valid & ~in_range).reshape(2, n).sum(dim=1)
    valid = valid & in_range

    words = _pack_keys(kb.keys, d, bits)                      # (2N, d1) each
    flat = tuple(torch.where(valid[:, None], w, _SENTINEL).reshape(-1)
                 for w in words)
    key = _key64(flat)
    key[m:] |= _TAG
    skey, perm = torch.sort(key, stable=True)
    perm = perm.to(_I32)
    sw = tuple(w[perm.long()] for w in flat)
    real = (sw[0] & _SENT_LO) != _SENT_LO
    diff = skey[1:] != skey[:-1]
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), diff]) & real

    num_unique = is_new.reshape(2, m).sum(dim=1, dtype=torch.int32)   # (2,)
    total_real = real.reshape(2, m).sum(dim=1, dtype=torch.int32)[:, None]
    overflow = (num_unique - capacity).clamp(min=0) + range_dropped
    # cloud 2's rank-q run starts where the global rank reaches q + nu1
    rank_base = (torch.cumsum(num_unique, dim=0, dtype=_I32) - num_unique)[:, None]
    ranks = (torch.cumsum(is_new.to(_I32), dim=0, dtype=_I32) - 1).reshape(2, m)
    q = torch.arange(capacity + 1, dtype=_I32, device=dev)
    starts = torch.searchsorted(ranks.reshape(-1), q + rank_base, side="left",
                                out_int32=True)                   # (2, cap + 1)
    ranks = ranks - rank_base
    lo = device_constant(np.array([[0], [m]], np.int32), dev)   # half offsets

    rank_idx = q[:capacity]
    nu = num_unique[:, None]
    rank_live = rank_idx < nu
    vertex_start = torch.where(rank_live, starts[:, :capacity] - lo, total_real)
    vertex_end = torch.where(rank_idx + 1 < nu, starts[:, 1:] - lo, total_real)
    vertex_end = torch.where(rank_live, vertex_end, vertex_start)
    vertex_valid = vertex_start < vertex_end

    safe_pos = starts[:, :capacity].clamp(max=2 * m - 1).long()
    vkeys = tuple(torch.where(vertex_valid, w[safe_pos], _SENTINEL) for w in sw)

    ids_sorted = torch.where(real & (ranks.reshape(-1) < capacity),
                             ranks.reshape(-1), -1)
    ids_flat = torch.empty_like(ids_sorted)
    ids_flat[perm.long()] = ids_sorted
    lattice_offset = ids_flat.reshape(2, n, d1)
    barycentric = torch.where(valid[:, None], kb.barycentric, 0.0).reshape(2, n, d1)
    el_minus_gr = torch.where(valid[:, None], kb.el_minus_gr, 0.0).reshape(2, n, d1)

    # the seam is a key change, so cloud 2's first entry starts a run; each
    # half is padded to whole 128-entry blocks, as local_ranks blocks it
    same_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), ~diff])
    pad = (-m) % 128
    same_prev = same_prev.reshape(2, m)
    if pad:
        same_prev = torch.cat([same_prev, same_prev.new_zeros(2, pad)], dim=1)
    lrank = local_ranks(same_prev.reshape(-1)).reshape(2, m + pad)
    perm = perm.reshape(2, m) - lo
    num_valid = num_unique.clamp(max=capacity).to(_I32)
    overflow = overflow.to(_I32)
    return tuple(CloudLattice(
        lattice_offset=lattice_offset[c],
        barycentric=barycentric[c],
        el_minus_gr=el_minus_gr[c],
        vkeys=tuple(w[c] for w in vkeys),
        vertex_valid=vertex_valid[c],
        num_valid=num_valid[c],
        overflow=overflow[c],
        splat_plan=ReducePlan(ids=lattice_offset[c].reshape(-1), perm=perm[c],
                              start=vertex_start[c], end=vertex_end[c],
                              lrank=lrank[c, :m], r0=ranks[c, ::128]),
    ) for c in range(2))


def _blur_queries(cl: CloudLattice, offsets: np.ndarray, d: int, bits: int):
    assert not offsets[0].any(), "stencil row 0 must be the zero offset"
    return _offset_queries(offsets[1:], cl.vkeys, cl.vertex_valid[None, :],
                           d, bits)


def _blur_table(cl: CloudLattice, idx, found) -> torch.Tensor:
    ok_v = cl.vertex_valid[None, :]
    h = cl.vkeys[0].shape[0]
    iota = torch.arange(h, dtype=_I32, device=ok_v.device)
    self_row = torch.where(cl.vertex_valid, iota, -1)[None, :]
    rest = torch.where(found & ok_v, idx, -1)
    return torch.cat([self_row, rest], dim=0)


def _neighbor_table(cl: CloudLattice, offsets: np.ndarray, d: int,
                    bits: int = 10) -> torch.Tensor:
    """(F, H) blur-neighbor ids; -1 = absent.  Row 0 is the zero offset."""
    return _blur_table(cl, *_probe(cl.vkeys, _blur_queries(cl, offsets, d, bits)))


def _neighbor_table_two(cl1: CloudLattice, cl2: CloudLattice,
                        offsets: np.ndarray, d: int, bits: int = 10) -> tuple:
    """Both clouds' :func:`_neighbor_table` from one fused probe."""
    i1, f1, i2, f2 = _probe_two(cl1.vkeys, _blur_queries(cl1, offsets, d, bits),
                                cl2.vkeys, _blur_queries(cl2, offsets, d, bits))
    return _blur_table(cl1, i1, f1), _blur_table(cl2, i2, f2)


def _corr_tables(cl1: CloudLattice, cl2: CloudLattice,
                 filter_offsets: np.ndarray, corr_offsets: np.ndarray, d: int,
                 pc1_corr: torch.Tensor | None = None,
                 with_inverse: bool = False, bits: int = 10,
                 fuse: bool = False):
    """Correlation index tables in unique-offset form.

    pc1_corr[c, h] = id of (key1[h] + corr_offsets[c]) in the cloud-1 table;
    the F x Cc combined offsets (filter + corr) collapse to U distinct ones
    (225 -> 65 at radius 1): uniq_tab[u, h] = id of key1[h] + uniq[u] in the
    cloud-2 table, and inverse[f, c] = u.  ``with_inverse`` also builds
    uniq_inv[u, r] = id1(key2[r] - uniq[u]), the backward's index map;
    ``fuse`` probes it in one join with ``uniq_tab`` (:func:`_probe_two`).
    """
    ok_v = cl1.vertex_valid[None, :]
    dev = ok_v.device
    if pc1_corr is None:
        cw = _offset_queries(corr_offsets, cl1.vkeys, ok_v, d, bits)
        idx1, found1 = _probe(cl1.vkeys, cw)
        pc1_corr = torch.where(found1 & ok_v, idx1, -1)

    combined = (filter_offsets[:, None, :].astype(np.int64)
                + corr_offsets[None, :, :]).reshape(-1, corr_offsets.shape[1])
    uniq, inverse = np.unique(combined, axis=0, return_inverse=True)
    nf, nc = filter_offsets.shape[0], corr_offsets.shape[0]
    inverse_m = device_constant(inverse.astype(np.int32).reshape(nf, nc), dev)

    qw = _offset_queries(uniq, cl1.vkeys, ok_v, d, bits)
    uniq_inv = torch.zeros((1, 1), dtype=_I32, device=dev)
    if with_inverse:
        ok_v2 = cl2.vertex_valid[None, :]
        rw = _offset_queries(-uniq, cl2.vkeys, ok_v2, d, bits)
        if fuse:
            idx2, found2, idx3, found3 = _probe_two(cl2.vkeys, qw, cl1.vkeys, rw)
        else:
            idx2, found2 = _probe(cl2.vkeys, qw)
            idx3, found3 = _probe(cl1.vkeys, rw)
        uniq_inv = torch.where(found3 & ok_v2, idx3, -1)
    else:
        idx2, found2 = _probe(cl2.vkeys, qw)
    uniq_tab = torch.where(found2 & ok_v, idx2, -1)
    return pc1_corr, uniq_tab, inverse_m, uniq_inv


def _next_elevated(cl: CloudLattice, d: int, scale: float, next_scale: float,
                   bits: int = 10):
    """Next scale's elevated coordinates, elementwise from the vertex keys.

    ``key * (next_scale / scale)`` as ONE float32 multiply of its own, never
    fused into the later ``elevated - greedy`` subtract: vertex-derived
    points sit exactly on rounding ties, and an unrounded product would flip
    them.  (Separate eager ops are never FMA-contracted.)
    """
    keys = _unpack_keys(cl.vkeys, d, bits)                  # (H, d1)
    keys = torch.where(cl.vertex_valid[:, None], keys, 0)
    ratio = np.float32(next_scale) / np.float32(scale)
    elevated = keys.to(torch.float32) * scalar(ratio, keys.device)
    return elevated, cl.vertex_valid


# ---------------------------------------------------------------------------
# full multi-scale pyramid
# ---------------------------------------------------------------------------

def _fused_build_threshold() -> int:
    """The largest capacity whose scale is built fused, from
    ``HPL_FUSED_BUILD``: ``"0"`` or empty (the default) fuses none (-1),
    ``"1"`` every scale, any other integer the scales of at most that
    capacity (the JAX package's policy)."""
    v = os.environ.get("HPL_FUSED_BUILD", "0").strip()
    if v in ("", "0"):
        return -1
    if v == "1":
        return 1 << 30
    return int(v)


def _scale_pair(ss: ScaleSpec, elev1, valid1, elev2, valid2, d: int,
                bits: int, fuse: bool, adjoint_plans: bool, zero, none):
    """One scale of :func:`build_pyramid`: -> (cloud 1's lattice, cloud
    2's, the ScalePair)."""
    with span("lattice.dedup"):
        if fuse and elev1.shape == elev2.shape:
            cl1, cl2 = _build_two_from_elevated(elev1, valid1, elev2, valid2,
                                                ss.capacity, bits)
        else:
            cl1 = _build_from_elevated(elev1, valid1, ss.capacity, bits)
            cl2 = _build_from_elevated(elev2, valid2, ss.capacity, bits)

    with span("lattice.tables"):
        nb1 = nb2 = none
        if ss.blur_radius != -1:
            offs = neighborhood_offsets(ss.blur_radius, d)
            if fuse:
                nb1, nb2 = _neighbor_table_two(cl1, cl2, offs, d, bits)
            else:
                nb1 = _neighbor_table(cl1, offs, d, bits)
                nb2 = _neighbor_table(cl2, offs, d, bits)

        corr1 = corr2u = corr2inv = corr2u_inv = none
        if ss.corr_filter_radius != -1:
            f_offs = neighborhood_offsets(ss.corr_filter_radius, d)
            c_offs = neighborhood_offsets(ss.corr_corr_radius, d)
            # identical stencil and table: the pc1 corr table is the blur one
            reuse = (ss.corr_corr_radius == ss.blur_radius
                     and ss.blur_radius != -1)
            corr1, corr2u, corr2inv, corr2u_inv = _corr_tables(
                cl1, cl2, f_offs, c_offs, d,
                pc1_corr=nb1 if reuse else None,
                with_inverse=adjoint_plans, bits=bits, fuse=fuse)

    return cl1, cl2, ScalePair(
        pc1_barycentric=cl1.barycentric,
        pc2_barycentric=cl2.barycentric,
        pc1_el_minus_gr=cl1.el_minus_gr,
        pc2_el_minus_gr=cl2.el_minus_gr,
        pc1_lattice_offset=cl1.lattice_offset,
        pc2_lattice_offset=cl2.lattice_offset,
        pc1_blur_neighbors=nb1,
        pc2_blur_neighbors=nb2,
        pc1_corr_indices=corr1,
        pc2_corr_uniq=corr2u,
        pc2_corr_inverse=corr2inv,
        pc1_num_valid=cl1.num_valid,
        pc2_num_valid=cl2.num_valid,
        pc1_overflow=cl1.overflow,
        pc2_overflow=cl2.overflow,
        pc1_splat_plan=cl1.splat_plan,
        pc2_splat_plan=cl2.splat_plan,
        pc2_corr_uniq_inv=corr2u_inv,
        probe_overflow=zero,
        stencil_overflow=zero,
    )


def build_pyramid(spec: LatticeSpec,
                  pc1: torch.Tensor,                 # (N, d) float32
                  pc2: torch.Tensor,
                  valid1: torch.Tensor | None = None,  # (N,) bool
                  valid2: torch.Tensor | None = None,
                  adjoint_plans: bool = True) -> list:
    """All per-scale lattice tables for a cloud pair (single sample).

    Runs on the points' device.  Scale 0 elevates the metric points; each
    deeper scale's points are the previous scale's (padded) vertices, with
    a validity mask.  ``adjoint_plans=False`` skips the backward-only
    ``pc2_corr_uniq_inv`` tables.  A scale whose capacity is within
    ``HPL_FUSED_BUILD``'s threshold (:func:`_fused_build_threshold`)
    probes both clouds in fused joins, and builds them from one sort when
    their point arrays have one shape; the tables are the same.

    Inside ``utils.profiling.tracing()`` it marks the spans
    ``lattice.build``, ``lattice.scale<i>`` per scale and, in each,
    ``lattice.dedup``, ``lattice.tables`` and ``lattice.next``, and counts
    ``lattice.vertices`` (both clouds' ``num_valid``) against
    ``lattice.rows`` (2 x capacity) per scale.
    """
    with span("lattice.build"):
        dev = pc1.device
        d = spec.d
        bits = spec.coord_bits
        if valid1 is None:
            valid1 = torch.ones(pc1.shape[0], dtype=torch.bool, device=dev)
        if valid2 is None:
            valid2 = torch.ones(pc2.shape[0], dtype=torch.bool, device=dev)
        elev1 = elevate(pc1, spec.scales[0].scale)
        elev2 = elevate(pc2, spec.scales[0].scale)
        zero = torch.zeros((), dtype=_I32, device=dev)
        none = torch.zeros((1, 1), dtype=_I32, device=dev)

        fuse_threshold = _fused_build_threshold()
        scales_out = []
        for i, ss in enumerate(spec.scales):
            with span(f"lattice.scale{i}"):
                cl1, cl2, sp = _scale_pair(
                    ss, elev1, valid1, elev2, valid2, d, bits,
                    ss.capacity <= fuse_threshold, adjoint_plans, zero, none)
                scales_out.append(sp)
                count("lattice.vertices", cl1.num_valid)
                count("lattice.vertices", cl2.num_valid)
                count("lattice.rows", 2 * ss.capacity)
                if i + 1 < len(spec.scales):
                    with span("lattice.next"):
                        nxt = spec.scales[i + 1].scale
                        elev1, valid1 = _next_elevated(cl1, d, ss.scale, nxt, bits)
                        elev2, valid2 = _next_elevated(cl2, d, ss.scale, nxt, bits)
        return scales_out


def build_scales(spec: LatticeSpec,
                 points: torch.Tensor,                # (N, d) float32
                 valid: torch.Tensor | None = None,   # (N,) bool
                 ) -> list:
    """One cloud's lattice at every scale of ``spec``, each elevated from
    ``points`` themselves, with its blur table -> one :class:`CloudScale`
    per scale.

    The scales are independent lattices of one cloud (SPLATNet3D's BCLs),
    not a pyramid: no scale is built from another's vertices.  Every scale
    blurs (its ``blur_radius``); the correlation radii are not read.  ``HPL_FUSED_BUILD`` does not apply:
    it fuses the two clouds of a pair, and there is one.  Marks the spans
    of :func:`build_pyramid` but ``lattice.next``, and counts
    ``lattice.vertices`` (the cloud's ``num_valid``) against
    ``lattice.rows`` (the capacity) per scale.
    """
    with span("lattice.build"):
        dev = points.device
        d, bits = spec.d, spec.coord_bits
        if valid is None:
            valid = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
        out = []
        for i, ss in enumerate(spec.scales):
            with span(f"lattice.scale{i}"):
                with span("lattice.dedup"):
                    cl = _build_from_elevated(elevate(points, ss.scale), valid,
                                              ss.capacity, bits)
                with span("lattice.tables"):
                    nb = _neighbor_table(
                        cl, neighborhood_offsets(ss.blur_radius, d), d, bits)
                out.append(CloudScale(cl, nb))
                count("lattice.vertices", cl.num_valid)
                count("lattice.rows", ss.capacity)
        return out


def default_capacities(num_points: int, scales: Sequence[Sequence[float]],
                       d: int = 3) -> list:
    """Measured static capacities per scale (see lattice/capacity.py)."""
    from .capacity import measured_default_capacities
    return measured_default_capacities(num_points, scales, d=d)
