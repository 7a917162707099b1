"""Batched shortest-path sweeps for alternative-path enumeration.

km runs an O(N^2) scan-min Dijkstra twice per target, one target at a
time (reference: km/utils/Graph.py:63-176 — hot loop #3). Catalog graphs
are small (hundreds of nodes) but there are hundreds of them, so the
device formulation batches them — and exploits their structure: a
(k-1)-overlap digraph has out-degree <= 4 (one per extending base) plus
a couple of cap edges, so adjacency is a fixed-width successor table
[B, n, W], never a dense [B, n, n] matrix. Every sweep of every target
(forward AND reverse — the reverse sweep is just a row built from the
transposed CSR) advances in lockstep inside ONE dispatch per size
bucket: argmin extraction + a W-lane gather + a W-lane scatter-relax
per iteration, vectorized over all sweeps.

Edge weights ride inside the successor table: real graphs use only a
handful of distinct weights (1.0 overlap / 0.01 reference-path,
km/utils/Graph.py:41-61,133-151), so each bucket carries a <=16-entry
float32 palette and each successor entry packs (node_id, palette_code)
into one integer: int16 for graphs up to 2048 nodes (the whole
catalog's adjacency uploads in a couple MB) and int32 beyond, up to
MAX_DEVICE_NODES = 16384 — past the reference's own hard cap of
max_node = 10000 (km/utils/MutationFinder.py:143-148), so every legal
graph runs on the device.

The iteration is step-for-step the reference algorithm, not an
approximation: extraction = argmin over a working distance array whose
visited entries are parked at +inf (lowest index on ties, like the
reference's array scan), relaxation = strict float32 improvement,
predecessor = the extracted node. Parked/unreachable nodes re-extract as
no-ops, so running the loop a fixed n iterations is equivalent to the
reference's exactly-n loop. The resulting predecessor trees are asserted
EQUAL (not approximately) to the host sweeps across the bundled fixtures
and adversarial random graphs (tests/test_pathgraph.py); splicing and
ref-edge removal stay on host (km_tpu.models.pathfinder).

Graphs that don't fit the device formulation (over MAX_DEVICE_NODES
nodes — impossible for a legal km run, the node budget exits first —
degree over MAX_WIDTH, or more than 16 distinct edge weights) fall
back to the host sweep with a log line; none of the bundled or catalog
workloads hit the fallback.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

MAX_INT16_NODES = 2048   # node-id budget of the compact int16 packing
MAX_DEVICE_NODES = 16384  # int32 packing bound; > max_node=10000 + caps
MAX_WIDTH = 64  # degree cap for the fixed-width successor table
PALETTE = 16  # distinct edge weights per bucket (catalog uses 2)


@partial(jax.jit, static_argnames=("B", "n", "W"))
def sweep_kernel_blob(blob, *, B, n, W):
    """Single-upload front end for sweep_kernel: the packed successor
    tables (int16 or int32), palettes (f32) and start nodes (i32) of a
    bucket ride ONE uint32 blob — one transfer per dispatch instead of
    three. Layout: [dtype_tag, packed...,
    palette..., starts...] with int16 tables packed two per word."""
    import jax.lax as lax

    tag = blob[0]
    off = 1
    n_tab = B * n * W
    is16 = n <= MAX_INT16_NODES  # _pack_bucket's dtype rule
    if is16:
        words = (n_tab + 1) // 2
        tab = lax.bitcast_convert_type(blob[off:off + words],
                                       jnp.int16).reshape(-1)[:n_tab]
    else:
        words = n_tab
        tab = blob[off:off + words].astype(jnp.int32)
    packed = tab.reshape(B, n, W).astype(jnp.int32)
    off += words
    palette = lax.bitcast_convert_type(
        blob[off:off + B * PALETTE], jnp.float32).reshape(B, PALETTE)
    off += B * PALETTE
    starts = blob[off:off + B].astype(jnp.int32)
    del tag
    return sweep_kernel(packed, palette, starts, n=n, W=W)


def _sweep_blob_host(packed, palette, starts) -> np.ndarray:
    """Host-side builder matching sweep_kernel_blob's layout."""
    flat = packed.reshape(-1)
    if packed.dtype == np.int16:
        if flat.size % 2:
            flat = np.concatenate([flat, np.zeros(1, np.int16)])
        words = flat.view(np.uint32)
    else:
        words = flat.astype(np.int32).view(np.uint32)
    return np.concatenate([
        np.zeros(1, np.uint32),  # reserved tag word
        words,
        np.ascontiguousarray(palette, dtype=np.float32).view(np.uint32)
        .reshape(-1),
        np.asarray(starts, np.int32).view(np.uint32)])


@partial(jax.jit, static_argnames=("n", "W"))
def sweep_kernel(packed, palette, starts, *, n, W):
    """Lockstep scan-min Dijkstra over a batch of sweeps.

    packed [B, n, W] int16: successor entries ``node_id * PALETTE +
    weight_code`` (-1 = empty lane); palette [B, PALETTE] float32;
    starts [B] int32. Returns predecessor trees [B, n] int32 (-1 =
    unreached), exactly the host scan-min's output.
    """
    B = packed.shape[0]
    rows = jnp.arange(B, dtype=jnp.int32)
    INF = jnp.float32(jnp.inf)

    cols = jnp.arange(n + 1, dtype=jnp.int32)
    p = packed.astype(jnp.int32)
    valid = p >= 0
    ids = jnp.where(valid, p // PALETTE, n)  # empty lanes -> parked col n
    codes = jnp.where(valid, p % PALETTE, 0)
    w = jnp.where(valid, palette[rows[:, None, None], codes], INF)

    # column n is a parking slot so empty lanes relax harmlessly
    dist0 = jnp.full((B, n + 1), INF).at[rows, starts].set(jnp.float32(0))
    prev0 = jnp.full((B, n + 1), -1, jnp.int32)

    # the relax step is scatter-free: a [B, W, n] one-hot expansion +
    # min-reduce, fully vectorized
    def body(_, state):
        dist, work, prev = state
        i = jnp.argmin(work[:, :n], axis=1).astype(jnp.int32)
        at_i = cols[None, :] == i[:, None]
        work = jnp.where(at_i, INF, work)
        sid = jnp.take_along_axis(ids, i[:, None, None], axis=1)[:, 0]
        sw = jnp.take_along_axis(w, i[:, None, None], axis=1)[:, 0]
        nd = sw + jnp.take_along_axis(dist, i[:, None], axis=1)  # f32
        onehot = sid[:, :, None] == cols[None, None, :]  # [B, W, n+1]
        cand = jnp.min(jnp.where(onehot, nd[:, :, None], INF), axis=1)
        better = cand < dist
        dist = jnp.where(better, cand, dist)
        work = jnp.where(better, cand, work)
        prev = jnp.where(better, i[:, None], prev)
        return dist, work, prev

    _, _, prev = jax.lax.fori_loop(0, n, body, (dist0, dist0, prev0))
    return prev[:, :n]


def _pack_bucket(sweeps, n_pad, W, uniq):
    """Pack many sweeps' CSR adjacencies into one [B, n_pad, W]
    successor table (int16 when node ids fit MAX_INT16_NODES, int32 up
    to MAX_DEVICE_NODES) in a handful of global numpy ops (per-sweep
    work is just array bookkeeping — the hot fill is one fancy-index
    write). Big graphs pad B to 2, not 8: a 16k-node sweep's lockstep
    iterations are expensive enough that ghost batch rows matter."""
    b_min = 8 if n_pad <= MAX_INT16_NODES else 2
    B = max(b_min, 1 << int(np.ceil(np.log2(max(len(sweeps), 2)))))
    dtype = np.int16 if n_pad <= MAX_INT16_NODES else np.int32
    deg_parts, row_parts, ids_parts, w_parts = [], [], [], []
    for s, (n, ptr, ids_flat, w_flat) in enumerate(sweeps):
        deg_parts.append(ptr[1:] - ptr[:-1])
        row_parts.append(s * n_pad + np.arange(n, dtype=np.int64))
        ids_parts.append(ids_flat)
        w_parts.append(w_flat)
    deg = np.concatenate(deg_parts).astype(np.int64)
    rows = np.repeat(np.concatenate(row_parts), deg)
    ids_all = np.concatenate(ids_parts).astype(np.int64)
    codes = np.searchsorted(uniq, np.concatenate(w_parts))
    starts = np.cumsum(deg) - deg
    lane = np.arange(len(ids_all), dtype=np.int64) - np.repeat(starts, deg)
    flat = np.full(B * n_pad * W, -1, dtype)
    flat[rows * W + lane] = ids_all * PALETTE + codes
    return flat.reshape(B, n_pad, W)


def _host_sweeps(g):
    return (g._sweep(g.first_node, g.succ_ptr, g.succ_ids, g.succ_w),
            g._sweep(g.last_node, g.pred_ptr, g.pred_ids, g.pred_w))


def batched_sweeps(graphs):
    """Run before/after sweeps for a list of frozen OverlapGraphs in
    size-bucketed single-dispatch device sweeps; returns
    [(before, after)] numpy pairs aligned with the input."""
    import logging as log

    out = [None] * len(graphs)
    # sweep rows: (graph_idx, direction); both directions of one graph
    # ride the same batch. Per-graph palettes are computed BEFORE any
    # grouping, so a single >PALETTE-weight outlier falls back alone
    # instead of dragging its whole bucket to the host sweep.
    eligible = []  # (gi, n_pad, W, uniq_weights)
    for gi, g in enumerate(graphs):
        deg_f = int((g.succ_ptr[1:] - g.succ_ptr[:-1]).max()) if g.n else 0
        deg_r = int((g.pred_ptr[1:] - g.pred_ptr[:-1]).max()) if g.n else 0
        uniq_g = np.unique(g.succ_w) if len(g.succ_w) \
            else np.empty(0, np.float32)
        if g.n > MAX_DEVICE_NODES or max(deg_f, deg_r) > MAX_WIDTH \
                or len(uniq_g) > PALETTE:
            log.info("pathgraph: graph (n=%d deg=%d weights=%d) exceeds "
                     "the device formulation, host sweep",
                     g.n, max(deg_f, deg_r), len(uniq_g))
            out[gi] = _host_sweeps(graphs[gi])
            continue
        n_pad = max(128, 1 << int(np.ceil(np.log2(max(g.n, 2)))))
        W = max(4, 1 << int(np.ceil(np.log2(max(deg_f, deg_r, 2)))))
        eligible.append((gi, n_pad, W, uniq_g))

    # Grouping: one dispatch per (lane width, size class, palette
    # group). Merging across W would inflate every graph's lanes to the
    # widest member (one W=64 graph would cost a W=4 catalog 16x), so
    # groups never mix W. Within a W, small graphs (n_pad <= 512) merge
    # into one batch (extra lockstep iterations on small graphs are
    # cheaper than extra dispatches); big graphs keep their
    # n_pad class. A group's palette union stays <= PALETTE — graphs
    # that don't fit the current union greedily open a new group.
    grouped: dict[tuple, list[list]] = {}
    for gi, n_pad, W, uniq_g in eligible:
        size_key = n_pad if n_pad > 512 else 0  # 0 = merged small class
        subs = grouped.setdefault((W, size_key), [])
        for sub in subs:
            union = np.union1d(sub[2], uniq_g)
            if len(union) <= PALETTE:
                sub[0].append(gi)
                sub[1] = max(sub[1], n_pad)
                sub[2] = union
                break
        else:
            subs.append([[gi], n_pad, uniq_g])

    # queue every dispatch before the first readback: JAX dispatch is
    # async, so device compute and host->device staging pipeline
    pending = []
    for (W, _size_key), subs in sorted(grouped.items()):
        for idxs, n_pad, uniq in subs:
            pal = np.ones(PALETTE, np.float32)
            pal[:len(uniq)] = uniq
            sweeps, starts = [], []
            for gi in idxs:
                g = graphs[gi]
                sweeps.append((g.n, g.succ_ptr, g.succ_ids, g.succ_w))
                sweeps.append((g.n, g.pred_ptr, g.pred_ids, g.pred_w))
                starts.extend((g.first_node, g.last_node))
            packed = _pack_bucket(sweeps, n_pad, W, uniq)
            B = packed.shape[0]
            palette = np.broadcast_to(pal, (B, PALETTE))
            starts = np.asarray(starts + [0] * (B - len(starts)), np.int32)
            blob = _sweep_blob_host(packed, palette, starts)
            pending.append((idxs, sweep_kernel_blob(
                jnp.asarray(blob), B=B, n=n_pad, W=W)))

    if len(pending) > 1:
        # one concatenated readback: all buckets' trees ride home in
        # one transfer
        flat = np.asarray(jnp.concatenate(
            [t.reshape(-1) for _, t in pending]))
        off = 0
        for idxs, trees_dev in pending:
            size = trees_dev.shape[0] * trees_dev.shape[1]
            trees = flat[off:off + size].reshape(trees_dev.shape)
            off += size
            for s, gi in enumerate(idxs):
                g = graphs[gi]
                out[gi] = (trees[2 * s, :g.n].copy(),
                           trees[2 * s + 1, :g.n].copy())
        return out

    for idxs, trees_dev in pending:
        trees = np.asarray(trees_dev)
        for s, gi in enumerate(idxs):
            g = graphs[gi]
            out[gi] = (trees[2 * s, :g.n].copy(),
                       trees[2 * s + 1, :g.n].copy())
    return out


def batched_alt_paths(finders) -> None:
    """Drive the full path-enumeration stage for many VariantFinders:
    graphs built on host, both sweeps batched on device, ref-edge
    removal + splicing on host. Sets finder.alt_paths."""
    graphs = []
    for f in finders:
        g = f.build_graph()
        g.freeze()
        graphs.append(g)
    trees = batched_sweeps(graphs)
    for f, g, (before, after) in zip(finders, graphs, trees):
        g.set_trees(before, after)
        f.paths_from_graph(g)
