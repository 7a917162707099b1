"""Masked frontier-expansion walk: the whole multi-target graph
discovery as ONE device program.

km's discovery is a recursive DFS making one Python->C++ query per k-mer
(reference: km/utils/MutationFinder.py:137-165). The host-orchestrated
batch walk (km_tpu.models.batch) already batches lookups, but still pays
one device dispatch per frontier round — hundreds of round trips. Here
the *entire* walk over hundreds of targets runs inside a single jitted
``lax.while_loop``.

Performance-critical design point: walklets are *slot-stable*. The
common event — a walklet extending through its single unknown child —
is a full-matrix elementwise write (one-hot depth mask), never a row
gather/scatter. The rare events go through small fixed side buffers:

- branching: the parent takes its first unknown child in place; the
  other unknown children copy the parent's stack through a
  ``copy_cap``-row buffer into dead slots;
- commits (a child hits the member set or the walklet's own stack):
  the stack row is gathered into a ``commit_cap``-row buffer and
  appended to a persistent log with one contiguous
  dynamic_update_slice;
- freed slots are re-seeded from the target k-mer list.

Instead of a row-scatter/gather of the whole [walklets, depth] stack
matrix every round, this formulation is elementwise + O(128) rows per
round.

All loop bounds are static; buffer overflow sets a flag and the host
retries with doubled capacities. The member set is static within a
dispatch, so discovery iterates to a fixpoint across dispatches (2
typically). The committed fixpoint matches the sequential engine on all
bundled fixtures (tests/test_device_walk.py); commit *timing* relative
to km's DFS ordering is the one documented semantic difference. Walk
budgets (max_stack depth, max_break branch events per path,
commit-on-reconnect-or-loop, per-parent child thresholds) are enforced
identically to the reference.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .device_table import children_kernel

TGT_SENTINEL = np.int32(0x7FFFFFF)


def _member_lookup(member_bounds, member_hi, member_lo, member_rounds,
                   tgt, chi, clo):
    """Binary search of (hi, lo) inside its target's slice of the
    (tgt, key)-sorted member arrays (traced helper shared by the walk
    and seed-filter kernels). Restricting the search to the per-target
    range [member_bounds[tgt], member_bounds[tgt+1]) cuts the lockstep
    round count from log2(total members) to log2(largest target's
    members) — roughly half at catalog scale."""
    M = member_hi.shape[0]
    zeros = jnp.zeros(jnp.broadcast_shapes(tgt.shape, chi.shape),
                      jnp.int32)
    low = member_bounds[tgt] + zeros
    high = member_bounds[tgt + 1] + zeros
    hi0 = high

    def body(_, lh):
        lo_, hi_ = lh
        mid = (lo_ + hi_) >> 1
        pos = jnp.minimum(mid, M - 1)
        mh, ml = member_hi[pos], member_lo[pos]
        less = (mh < chi) | ((mh == chi) & (ml < clo))
        return (jnp.where(less, mid + 1, lo_),
                jnp.where(less, hi_, mid))

    low, _ = jax.lax.fori_loop(0, member_rounds, body, (low, high))
    pos = jnp.minimum(low, M - 1)
    return ((low < hi0) & (member_hi[pos] == chi)
            & (member_lo[pos] == clo))


def _seed_filter(keys_hi, keys_lo, counts, bucket_starts,
                 member_bounds, member_hi, member_lo,
                 seed_tgt, seed_hi, seed_lo, n_act, ratio, n_cutoff,
                 *, prefix_bits, rounds, k, canonical, member_rounds):
    """Batched seed filter: a seed whose children are all known (member
    set or the seed itself) dies in its first walk round with no side
    effects — depth-1 walklets can neither commit (commits need depth
    >= 2) nor exhaust the branch budget (one event <= 10) — so only
    seeds with at least one unknown child need walklet slots. Returns
    the keep mask. Runs INSIDE walk_kernel (fused: the filter verdict
    never visits the host, saving a dispatch and a readback per
    fixpoint iteration)."""
    import jax.numpy as jnp

    chi, clo, _cnt, kid_mask = children_kernel(
        keys_hi, keys_lo, counts, bucket_starts, seed_hi, seed_lo,
        ratio, n_cutoff, prefix_bits=prefix_bits, rounds=rounds,
        k=k, canonical=canonical, forward=True)
    known = _member_lookup(member_bounds, member_hi, member_lo,
                           member_rounds, seed_tgt[:, None], chi, clo)
    self_loop = (chi == seed_hi[:, None]) & (clo == seed_lo[:, None])
    in_range = jnp.arange(seed_hi.shape[0], dtype=jnp.int32) < n_act
    return (kid_mask & ~known & ~self_loop).any(axis=1) & in_range


@partial(jax.jit, static_argnames=(
    "prefix_bits", "rounds", "k", "canonical", "max_stack", "max_break",
    "member_rounds", "hard_rounds", "copy_cap", "commit_cap", "log_cap",
    "WC", "S", "NS", "TB", "M"))
def walk_kernel_blob(keys_hi, keys_lo, counts, bucket_starts, blob,
                     n_act, ratio, n_cutoff,
                     *, NS, TB, M, WC, S, prefix_bits, rounds, k,
                     canonical, max_stack, max_break, member_rounds,
                     hard_rounds, copy_cap, commit_cap, log_cap):
    """Single-upload front end for walk_kernel: seeds, member arrays
    and slice bounds ride ONE uint32 blob — one host->device transfer
    per fixpoint iteration instead of six."""
    off = 0
    seed_tgt = blob[off:off + NS].astype(jnp.int32)
    off += NS
    seed_hi = blob[off:off + NS]
    off += NS
    seed_lo = blob[off:off + NS]
    off += NS
    member_bounds = blob[off:off + TB + 1].astype(jnp.int32)
    off += TB + 1
    member_hi = blob[off:off + M]
    off += M
    member_lo = blob[off:off + M]
    return walk_kernel(
        keys_hi, keys_lo, counts, bucket_starts,
        member_bounds, member_hi, member_lo,
        seed_tgt, seed_hi, seed_lo, n_act, ratio, n_cutoff,
        WC=WC, S=S, prefix_bits=prefix_bits, rounds=rounds, k=k,
        canonical=canonical, max_stack=max_stack, max_break=max_break,
        member_rounds=member_rounds, hard_rounds=hard_rounds,
        copy_cap=copy_cap, commit_cap=commit_cap, log_cap=log_cap)


@partial(jax.jit, static_argnames=(
    "prefix_bits", "rounds", "k", "canonical", "max_stack", "max_break",
    "member_rounds", "hard_rounds", "copy_cap", "commit_cap", "log_cap",
    "WC", "S"))
def walk_kernel(keys_hi, keys_lo, counts, bucket_starts,
                member_bounds, member_hi, member_lo,
                seed_tgt, seed_hi, seed_lo, n_act,
                ratio, n_cutoff,
                *, WC, S, prefix_bits, rounds, k, canonical, max_stack,
                max_break, member_rounds, hard_rounds, copy_cap,
                commit_cap, log_cap):
    """One fixpoint iteration of the device walk, with the seed filter
    FUSED in front: the kernel receives all currently-active seeds,
    filters them (see _seed_filter), compacts the survivors on device,
    and walks only those — one dispatch and one readback per fixpoint
    iteration instead of two of each. Returns one packed uint32
    vector: [log_count, buffer_overflow, depth_overflow (a walklet
    needed more than S stack rows while max_stack allowed deeper —
    host retries with S doubled), round_count] followed by
    log_tgt[log_cap], log_depth[log_cap], log_hi[log_cap*S],
    log_lo[log_cap*S], keep_bits[NS/32] (the filter verdict, 32 seeds
    per uint32 little-endian — the host's next active set)."""
    NS = seed_hi.shape[0]
    keep = _seed_filter(
        keys_hi, keys_lo, counts, bucket_starts, member_bounds,
        member_hi, member_lo, seed_tgt, seed_hi, seed_lo, n_act,
        ratio, n_cutoff, prefix_bits=prefix_bits, rounds=rounds, k=k,
        canonical=canonical, member_rounds=member_rounds)
    # stable on-device compaction of the survivors
    rank = jnp.cumsum(keep.astype(jnp.int32)) - 1
    n_seeds = keep.sum()
    slot = jnp.where(keep, rank, NS)
    surv_tgt = jnp.zeros(NS + 1, jnp.int32).at[slot].set(seed_tgt)[:NS]
    surv_hi = jnp.zeros(NS + 1, jnp.uint32).at[slot].set(seed_hi)[:NS]
    surv_lo = jnp.zeros(NS + 1, jnp.uint32).at[slot].set(seed_lo)[:NS]
    seed_tgt, seed_hi, seed_lo = surv_tgt, surv_hi, surv_lo
    keep_bits = (keep.reshape(-1, 32).astype(jnp.uint32)
                 << jnp.arange(32, dtype=jnp.uint32)[None, :]).sum(
                     axis=1, dtype=jnp.uint32)

    lanes = jnp.arange(4, dtype=jnp.int32)
    rows = jnp.arange(WC, dtype=jnp.int32)
    cols = jnp.arange(S, dtype=jnp.int32)

    def member_lookup(tgt, chi, clo):
        return _member_lookup(member_bounds, member_hi, member_lo,
                              member_rounds, tgt, chi, clo)

    def round_body(state):
        (stack_hi, stack_lo, w_tgt, w_breaks, w_depth, w_alive, cursor,
         log_hi, log_lo, log_tgt, log_depth, log_count, overflow,
         depth_ovf, rnd) = state

        # --- tips and children ---
        tip_pos = jnp.maximum(w_depth - 1, 0)
        tips_hi = jnp.take_along_axis(stack_hi, tip_pos[:, None],
                                      axis=1)[:, 0]
        tips_lo = jnp.take_along_axis(stack_lo, tip_pos[:, None],
                                      axis=1)[:, 0]
        chi, clo, _cnt, kid_mask = children_kernel(
            keys_hi, keys_lo, counts, bucket_starts, tips_hi, tips_lo,
            ratio, n_cutoff, prefix_bits=prefix_bits, rounds=rounds,
            k=k, canonical=canonical, forward=True)
        kid_mask = kid_mask & w_alive[:, None]

        nkids = kid_mask.sum(axis=1)
        branches = nkids > 1
        b2 = w_breaks + branches.astype(jnp.int32)
        die_branch = branches & (b2 > max_break)
        act = w_alive & ~die_branch

        # --- membership tests ---
        known_member = member_lookup(w_tgt[:, None], chi, clo) & kid_mask
        depth_mask = (cols[None, None, :] < w_depth[:, None, None])
        in_stack = (((stack_hi[:, None, :] == chi[:, :, None])
                     & (stack_lo[:, None, :] == clo[:, :, None])
                     & depth_mask).any(axis=2)) & kid_mask
        known = known_member | in_stack

        # --- commits: gather committing rows into the small buffer,
        # append to the log with one contiguous write ---
        committing = act & known.any(axis=1) & (w_depth >= 2)
        n_commit = committing.sum()
        crank = jnp.cumsum(committing.astype(jnp.int32)) - 1
        # walklet index per buffer slot (scatter of WC scalars)
        src = jnp.zeros(commit_cap + 1, jnp.int32).at[
            jnp.where(committing, jnp.minimum(crank, commit_cap), commit_cap)
        ].set(rows)[:commit_cap]
        buf_hi = stack_hi[src]
        buf_lo = stack_lo[src]
        buf_valid = jnp.arange(commit_cap) < n_commit
        buf_tgt = jnp.where(buf_valid, w_tgt[src], TGT_SENTINEL)
        buf_depth = jnp.where(buf_valid, w_depth[src], 0)
        off = jnp.minimum(log_count, log_cap - commit_cap)
        log_hi = jax.lax.dynamic_update_slice(log_hi, buf_hi,
                                              (off, jnp.int32(0)))
        log_lo = jax.lax.dynamic_update_slice(log_lo, buf_lo,
                                              (off, jnp.int32(0)))
        log_tgt = jax.lax.dynamic_update_slice(log_tgt, buf_tgt, (off,))
        log_depth = jax.lax.dynamic_update_slice(log_depth, buf_depth,
                                                 (off,))
        overflow = overflow | (n_commit > commit_cap) \
            | (log_count + commit_cap > log_cap)
        log_count = log_count + jnp.minimum(n_commit, commit_cap)

        # --- in-place extension through the first unknown child ---
        # S may be smaller than max_stack (stacks start shallow for
        # speed); a walklet that could legally go deeper than its S rows
        # flags a depth overflow and the host retries with S doubled
        unknown_sem = (act[:, None] & kid_mask & ~known
                       & (w_depth[:, None] + 1 <= max_stack))
        depth_ovf = depth_ovf | (
            unknown_sem & (w_depth[:, None] + 1 > S)).any()
        unknown = unknown_sem & (w_depth[:, None] + 1 <= S)
        n_unknown = unknown.sum(axis=1)
        first_lane = jnp.argmax(unknown, axis=1)
        ext = n_unknown >= 1
        ext_hi = jnp.take_along_axis(chi, first_lane[:, None], 1)[:, 0]
        ext_lo = jnp.take_along_axis(clo, first_lane[:, None], 1)[:, 0]
        at_new = (cols[None, :] == w_depth[:, None]) & ext[:, None]
        stack_hi = jnp.where(at_new, ext_hi[:, None], stack_hi)
        stack_lo = jnp.where(at_new, ext_lo[:, None], stack_lo)
        w_depth = jnp.where(ext, w_depth + 1, w_depth)
        w_breaks = jnp.where(ext, b2, w_breaks)
        alive2 = ext  # walklets without an extension die this round

        # --- extra unknown children copy the parent into dead slots ---
        extra = unknown & (lanes[None, :] != first_lane[:, None])
        extra_flat = extra.reshape(-1)
        n_extra = extra_flat.sum()
        erank = jnp.cumsum(extra_flat.astype(jnp.int32)) - 1
        flat_ix = jnp.arange(WC * 4, dtype=jnp.int32)
        cp_src = jnp.zeros(copy_cap + 1, jnp.int32).at[
            jnp.where(extra_flat, jnp.minimum(erank, copy_cap), copy_cap)
        ].set(flat_ix // 4)[:copy_cap]
        cp_child_hi = jnp.zeros(copy_cap + 1, jnp.uint32).at[
            jnp.where(extra_flat, jnp.minimum(erank, copy_cap), copy_cap)
        ].set(chi.reshape(-1))[:copy_cap]
        cp_child_lo = jnp.zeros(copy_cap + 1, jnp.uint32).at[
            jnp.where(extra_flat, jnp.minimum(erank, copy_cap), copy_cap)
        ].set(clo.reshape(-1))[:copy_cap]
        overflow = overflow | (n_extra > copy_cap)

        dead = ~alive2
        drank = jnp.where(dead, jnp.cumsum(dead.astype(jnp.int32)) - 1, -1)
        n_dead = dead.sum()
        # destination slot per copy buffer entry
        cp_dst = jnp.full(copy_cap + 1, WC, jnp.int32).at[
            jnp.where(dead & (drank < copy_cap), drank, copy_cap)
        ].set(rows)[:copy_cap]
        cp_valid = jnp.arange(copy_cap) < jnp.minimum(n_extra, n_dead)
        # build copied rows: parent stack + child at parent depth
        cp_rows_hi = stack_hi[cp_src]  # parent already extended in place;
        cp_rows_lo = stack_lo[cp_src]  # overwrite its new cell with ours
        cp_depth = w_depth[cp_src]  # parent depth after +1 == our depth
        cp_at = (cols[None, :] == (cp_depth - 1)[:, None])
        cp_rows_hi = jnp.where(cp_at, cp_child_hi[:, None], cp_rows_hi)
        cp_rows_lo = jnp.where(cp_at, cp_child_lo[:, None], cp_rows_lo)
        dst = jnp.where(cp_valid, cp_dst, WC)
        stack_hi = stack_hi.at[dst].set(cp_rows_hi, mode="drop")
        stack_lo = stack_lo.at[dst].set(cp_rows_lo, mode="drop")
        w_tgt = w_tgt.at[dst].set(w_tgt[cp_src], mode="drop")
        w_breaks = w_breaks.at[dst].set(w_breaks[cp_src], mode="drop")
        w_depth = w_depth.at[dst].set(cp_depth, mode="drop")
        alive2 = alive2.at[dst].set(True, mode="drop")
        overflow = overflow | (n_extra > n_dead)  # pool exhausted

        # --- refill remaining dead slots with fresh seeds ---
        n_copied = jnp.minimum(n_extra, n_dead)
        seed_ix = cursor + (drank - n_copied)
        is_seed = dead & (drank >= n_copied) & (seed_ix < n_seeds) \
            & (seed_ix >= 0)
        seed_pos = jnp.clip(seed_ix, 0, seed_hi.shape[0] - 1)
        w_tgt = jnp.where(is_seed, seed_tgt[seed_pos], w_tgt)
        w_breaks = jnp.where(is_seed, 0, w_breaks)
        w_depth = jnp.where(is_seed, 1, w_depth)
        first_col = (cols[None, :] == 0) & is_seed[:, None]
        stack_hi = jnp.where(first_col, seed_hi[seed_pos][:, None],
                             stack_hi)
        stack_lo = jnp.where(first_col, seed_lo[seed_pos][:, None],
                             stack_lo)
        alive2 = alive2 | is_seed
        cursor = cursor + is_seed.sum()

        return (stack_hi, stack_lo, w_tgt, w_breaks, w_depth, alive2,
                cursor, log_hi, log_lo, log_tgt, log_depth, log_count,
                overflow, depth_ovf, rnd + 1)

    def cond(state):
        alive = state[5]
        cursor = state[6]
        overflow = state[12]
        depth_ovf = state[13]
        rnd = state[14]
        return ((alive.any() | (cursor < n_seeds))
                & (rnd < hard_rounds) & ~overflow & ~depth_ovf)

    state = (
        jnp.zeros((WC, S), jnp.uint32), jnp.zeros((WC, S), jnp.uint32),
        jnp.zeros(WC, jnp.int32), jnp.zeros(WC, jnp.int32),
        jnp.ones(WC, jnp.int32), jnp.zeros(WC, bool), jnp.int32(0),
        jnp.zeros((log_cap, S), jnp.uint32),
        jnp.zeros((log_cap, S), jnp.uint32),
        jnp.full(log_cap, TGT_SENTINEL, jnp.int32),
        jnp.zeros(log_cap, jnp.int32), jnp.int32(0), jnp.bool_(False),
        jnp.bool_(False), jnp.int32(0))
    state = jax.lax.while_loop(cond, round_body, state)
    (_, _, _, _, _, _, _, log_hi, log_lo, log_tgt, log_depth, log_count,
     overflow, depth_ovf, rnd) = state
    # single packed buffer: everything rides one uint32 vector, one
    # device->host transfer
    return jnp.concatenate([
        jnp.stack([log_count.astype(jnp.uint32),
                   overflow.astype(jnp.uint32),
                   depth_ovf.astype(jnp.uint32),
                   rnd.astype(jnp.uint32)]),
        log_tgt.astype(jnp.uint32), log_depth.astype(jnp.uint32),
        log_hi.reshape(-1), log_lo.reshape(-1), keep_bits])


# stack depth that sufficed last time (per process): starting at the
# learned value avoids a wasted abort-and-retry dispatch per call
_learned_stack_cap = 64


def device_discover(targets_mers: list[np.ndarray], table, ratio=0.05,
                    count=5, max_stack=500, max_break=10, max_node=10000,
                    walklet_cap=2048, copy_cap=128, commit_cap=128,
                    log_cap=512, stack_cap=None, on_budget="raise",
                    defer_counts=False):
    """Fixpoint driver for the device walk.

    targets_mers: per-target ordered unique packed ref k-mers (uint64).
    Returns per-target ordered {kmer: count} (ref k-mers first, then
    commits in log order), like the host walkers. With
    on_budget='skip', a target that outgrows max_node returns None
    instead of aborting the whole batch (models.batch.run_catalog
    documents the semantics).

    defer_counts=True instead returns (orders, fetch): per-target
    ordered key lists (None for budget-failed targets) with the count
    resolution *dispatched but not read back* — fetch() materializes
    the {kmer: count} dicts later, so the caller can overlap host work
    (graph building) with the device query's round trip.
    """
    from .device_table import split_keys
    from ..models.walk import NodeBudgetExceeded

    seed_tgt = np.concatenate([
        np.full(len(m), t, np.int32) for t, m in enumerate(targets_mers)])
    seed_keys = np.concatenate(targets_mers).astype(np.uint64)
    shi, slo = split_keys(seed_keys)
    n_seeds = len(seed_keys)

    node_sets = [set(int(x) for x in m) for m in targets_mers]
    node_order = [[int(x) for x in m] for m in targets_mers]

    global _learned_stack_cap
    # every per-round op touches the whole [WC, S] stack matrix, so S is
    # the per-round cost knob: start shallow (catalog walks commit at
    # depth ~32) and let the depth-overflow flag retry deeper walks
    if stack_cap is None:
        stack_cap = _learned_stack_cap
    S = min(max(8, stack_cap), max(8, max_stack))
    hard_rounds = 1 << 22  # while_loop exits via its dynamic condition

    n_targets = len(targets_mers)
    # per-target member-slice bounds array, padded to a power of two for
    # compile-shape stability (padding targets get empty slices)
    TB = max(64, 1 << max(n_targets.bit_length(), 1))

    # seeds eligible for the filter pass: iteration 1 filters everything;
    # later iterations only re-filter prior survivors — a dropped seed's
    # children can only become MORE known as the member set grows, so it
    # stays droppable forever
    active = np.arange(n_seeds, dtype=np.int64)
    failed: set[int] = set()

    # Compile-class normalization: every shape axis below is frozen at
    # its first-iteration value (member/seed sets only shrink or grow
    # within one run, monotonically), and the member array quantizes in
    # x4 steps, so a never-seen catalog compiles the (filter-fused)
    # walk kernel ONCE — not a fresh class per fixpoint iteration.
    M_f = NS_f = WC_f = 0

    for _iteration in range(64):  # fixpoint iterations (typically 2)
        sizes = np.fromiter((len(order) for order in node_order),
                            dtype=np.int64, count=n_targets)
        m_keys = np.concatenate([
            np.fromiter(order, dtype=np.uint64, count=len(order))
            for order in node_order])
        # node_order is per-target already; sort keys within each slice
        bounds = np.zeros(TB + 1, np.int32)
        np.cumsum(sizes, out=bounds[1:n_targets + 1])
        bounds[n_targets + 1:] = bounds[n_targets]
        for t in range(n_targets):
            m_keys[bounds[t]:bounds[t + 1]].sort()
        mhi, mlo = split_keys(m_keys)
        # x4 quantization (even exponents): member growth across
        # iterations rarely crosses a class boundary
        b = max(16, (max(len(m_keys), 2) - 1).bit_length())
        M = max(1 << (b + (b & 1)), M_f)
        M_f = M
        # the in-slice binary search converges in log2(largest slice);
        # 15 covers every legal catalog (slices are node-budget-bounded
        # at max_node=10000 < 2^14), so the static axis is a constant
        # instead of a fresh compile class per catalog shape
        member_rounds = max(15, int(sizes.max()).bit_length() + 1)
        pad = M - len(m_keys)
        mhi = np.concatenate([mhi, np.full(pad, 0xFFFFFFFF, np.uint32)])
        mlo = np.concatenate([mlo, np.full(pad, 0xFFFFFFFF, np.uint32)])

        # all active seeds go to the walk kernel; its fused filter pass
        # kills the seeds that would die in their first walk round (the
        # vast majority: every interior reference k-mer whose children
        # are all on the reference path) and walks only the survivors —
        # one dispatch per fixpoint iteration
        na = len(active)
        NS = max(1 << 10, 1 << (na - 1).bit_length(), NS_f)
        NS_f = NS
        sp = NS - na
        # seeds + member arrays + slice bounds ride one u32 blob = ONE
        # host->device transfer per iteration (walk_kernel_blob)
        blob = np.concatenate([
            seed_tgt[active].astype(np.int32).view(np.uint32),
            np.zeros(sp, np.uint32),
            shi[active], np.zeros(sp, np.uint32),
            slo[active], np.zeros(sp, np.uint32),
            bounds.astype(np.int32).view(np.uint32), mhi, mlo])
        # fixed walklet pool: the survivor count is only known on
        # device now, and a survivor-sized WC would cost a compile
        # class per size. 512 rows is catalog-right — every per-round
        # op scans all WC rows, so a maximal pool measurably slowed
        # warm walks (r5: 1.65s vs 1.3s at WC=2048); surplus survivors
        # just stream through the pool over extra device-internal
        # rounds, never a dispatch
        WC = min(walklet_cap, max(512, WC_f))

        while True:
            out = walk_kernel_blob(
                table.keys_hi, table.keys_lo, table.counts,
                table.bucket_starts, jnp.asarray(blob),
                jnp.int32(na), jnp.float32(ratio), jnp.int32(count),
                NS=NS, TB=TB, M=M,
                WC=WC, S=S,
                prefix_bits=table.prefix_bits, rounds=table.rounds,
                k=table.k, canonical=table.canonical, max_stack=max_stack,
                max_break=max_break, member_rounds=member_rounds,
                hard_rounds=hard_rounds, copy_cap=copy_cap,
                commit_cap=commit_cap, log_cap=log_cap)
            buf = np.asarray(out)
            c_count, overflow, depth_ovf, _rnd = (int(x)
                                                  for x in buf[:4])
            off = 4
            c_tgt = buf[off:off + log_cap].astype(np.int32)
            off += log_cap
            c_depth = buf[off:off + log_cap].astype(np.int32)
            off += log_cap
            c_hi = buf[off:off + log_cap * S].reshape(log_cap, S)
            off += log_cap * S
            c_lo = buf[off:off + log_cap * S].reshape(log_cap, S)
            off += log_cap * S
            keep_words = buf[off:off + NS // 32]
            if not overflow and not depth_ovf:
                break
            if depth_ovf:
                S = min(S * 2, max(8, max_stack))
            if overflow:
                WC *= 2
                copy_cap *= 2
                commit_cap *= 2
                log_cap *= 2
        WC_f = WC  # an overflow-doubled class carries to later iterations
        keep_mask = (((keep_words[:, None]
                       >> np.arange(32, dtype=np.uint32)) & 1)
                     .astype(bool).reshape(-1)[:na])
        surv = active[keep_mask]

        # apply commits in log order
        changed = False
        for i in range(int(c_count)):
            t = int(c_tgt[i])
            if t == TGT_SENTINEL or t in failed:
                continue
            d = int(c_depth[i])
            keys = ((c_hi[i, :d].astype(np.uint64) << np.uint64(32))
                    | c_lo[i, :d].astype(np.uint64))
            ns, order = node_sets[t], node_order[t]
            for key in keys:
                key = int(key)
                if key not in ns:
                    ns.add(key)
                    order.append(key)
                    changed = True
            if len(order) > max_node:
                if on_budget == "raise":
                    raise NodeBudgetExceeded(max_node)
                failed.add(t)
        if not changed:
            break
        active = surv  # only prior survivors can still have unknown kids
        if failed:  # failed targets' seeds stop walking
            active = active[~np.isin(seed_tgt[active],
                                     np.fromiter(failed, np.int32,
                                                 len(failed)))]

    _learned_stack_cap = S  # next call starts at the depth that sufficed

    # count resolution: one batched query across every target,
    # DISPATCHED here; the readback happens in _materialize (or right
    # away unless defer_counts)
    all_keys = np.concatenate([
        np.array(order, dtype=np.uint64) for order in node_order]) \
        if node_order else np.empty(0, np.uint64)
    dev_counts = None
    n_all = len(all_keys)
    if n_all:
        padded = max(64, 1 << (n_all - 1).bit_length())
        buf = np.zeros(padded, dtype=np.uint64)
        buf[:n_all] = all_keys
        qhi, qlo = split_keys(buf)
        dev_counts = table.lookup(jnp.asarray(qhi), jnp.asarray(qlo))

    def _materialize():
        counts = (np.asarray(dev_counts).astype(np.int64)[:n_all]
                  if dev_counts is not None else np.empty(0, np.int64))
        results = []
        off = 0
        for t, order in enumerate(node_order):
            n = len(order)
            # dict(zip(...)) over ready python lists runs at C speed;
            # the elementwise int() comprehension it replaces was ~25%
            # of the whole warm walk on a 400-target catalog
            results.append(None if t in failed else
                           dict(zip(order, counts[off:off + n].tolist())))
            off += n
        return results

    if defer_counts:
        orders = [None if t in failed else node_order[t]
                  for t in range(n_targets)]
        return orders, _materialize
    return _materialize()
