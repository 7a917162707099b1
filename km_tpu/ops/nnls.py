"""Batched non-negative least squares on device.

One catalog run produces hundreds of small quantification problems (a
few paths x a few hundred k-mers each — reference hot loop:
km/utils/PathQuant.py:111-149). The host spec (km_tpu.models.quant)
solves them one at a time; here the iterative refinement — thousands of
tiny matvec iterations, the expensive part — runs for ALL problems
across ALL targets as one jitted while_loop dispatch.

Why the split below: the projected-gradient iteration stops the first
time max|grad| <= 0.01, so the reported coefficients depend on the
whole TRAJECTORY, not just the minimizer — two arithmetically close
starts can stop at answers that differ at the %.1f rounding contract.
Float32 batch math provably cannot guarantee the byte contract on
general problems (it failed on random inputs in round 2). Therefore:

- initial fit: per-problem ``np.linalg.lstsq`` on host — the literal
  spec operation, so every trajectory STARTS bit-identically (this also
  covers rank-deficient problems, e.g. an alt path equal to the
  reference path, exactly like the spec);
- refinement: the spec's iteration (step 0.1 x mean gradient,
  post-update clamp, stop at max|grad| <= 0.01) batched on device in
  FLOAT64 (``jax.enable_x64``; these problems are tiny), with
  per-problem freezing: each problem
  stops updating the iteration its own gradient test passes, exactly
  like the sequential loop, while the batch keeps stepping until the
  last problem converges.

The only remaining divergence from the host spec is float64 reduction
order inside the matvecs (~1e-15 relative per iteration), far below the
%.3f/%.1f rounding contract; equality of the rounded report fields is
asserted on the bundled fixtures AND on random adversarial problems
(tests/test_nnls.py) and at the pipeline level
(tests/test_batch_pipeline.py).

Padding is inert by construction: zero k-mer rows add zero residual and
zero gradient, zero path columns get zero gradient; the mean-gradient
divisor uses each problem's REAL k-mer count.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

MAX_ITERS = 200_000  # safety bound; fixtures converge in < 2k iterations


@partial(jax.jit, static_argnames=("B", "N", "P"))
def _refine_blob(blob, *, B, N, P):
    """Single-upload front end for _refine_kernel (one transfer per
    dispatch instead of four): one uint32 blob
    carries contrib (i16, two per word), counts (f32), coef0 and
    n_kmers (f64, two words each, little-endian); coef and rvaf return
    stacked as one f64 array so the readback is also a single
    transfer. Must be traced under jax.enable_x64 (the f64 bitcasts)."""
    import jax.lax as lax

    off = 0
    w = B * N * P // 2
    contrib16 = lax.bitcast_convert_type(
        blob[:w], jnp.int16).reshape(B, N, P)
    off = w
    counts32 = lax.bitcast_convert_type(
        blob[off:off + B * N], jnp.float32).reshape(B, N)
    off += B * N
    coef0 = lax.bitcast_convert_type(
        blob[off:off + 2 * B * P].reshape(B, P, 2), jnp.float64)
    off += 2 * B * P
    n_kmers = lax.bitcast_convert_type(
        blob[off:off + 2 * B].reshape(B, 2), jnp.float64)
    coef, rvaf, _iters = _refine_kernel(contrib16, counts32, coef0,
                                        n_kmers)
    return jnp.stack([coef, rvaf])


@jax.jit
def _refine_kernel(contrib16, counts32, coef0, n_kmers):
    """contrib16 [B,N,P] int16 occurrence counts, counts32 [B,N] f32,
    coef0 [B,P] f64 (already clamped >= 0), n_kmers [B] f64 (real row
    counts). The narrow integer/f32 inputs exist purely to shrink the
    host->device upload; they are
    exact value-preserving encodings within their ranges (counts <
    2^24, occurrences < 2^15 — solve_batch routes anything larger to
    the host spec solver) and widen to f64 on device before any
    arithmetic. Returns (coef [B,P], rvaf [B,P], iters)."""
    contrib = contrib16.astype(jnp.float64)
    counts = counts32.astype(jnp.float64)

    def cond(state):
        _, done, it = state
        return (~done).any() & (it < MAX_ITERS)

    def step(coef, done):
        counts_hat = jnp.einsum("bnp,bp->bn", contrib, coef)
        grad = 2.0 * jnp.einsum("bn,bnp->bp", counts - counts_hat,
                                contrib) / n_kmers[:, None]
        new_coef = coef + 0.1 * grad
        grad = jnp.where(new_coef < 0, 0.0, grad)
        new_coef = jnp.maximum(new_coef, 0.0)
        max_grad = jnp.abs(grad).max(axis=-1)
        coef = jnp.where(done[:, None], coef, new_coef)
        done = done | (max_grad <= 0.01)
        return coef, done

    # 8 spec iterations per while step: per-problem freezing keeps each
    # problem's trajectory exactly the sequential spec's (a frozen
    # problem's extra masked iterations are no-ops), while the unroll
    # amortizes the while_loop's per-iteration dispatch overhead
    UNROLL = 8

    def body(state):
        coef, done, it = state
        for _ in range(UNROLL):
            coef, done = step(coef, done)
        return coef, done, it + UNROLL

    done0 = jnp.zeros(contrib.shape[0], dtype=bool)
    coef, _done, iters = jax.lax.while_loop(
        cond, body, (coef0, done0, jnp.int32(0)))

    total = coef.sum(axis=-1, keepdims=True)
    all_zero = coef.max(axis=-1, keepdims=True) == 0
    rvaf = jnp.where(all_zero, coef,
                     coef / jnp.where(all_zero, 1.0, total))
    return coef, rvaf, iters


def solve_batch(problems, pad_paths: int | None = None,
                pad_kmers: int | None = None, defer: bool = False):
    """Solve many NNLS problems in one device dispatch.

    problems: list of (paths, counts) — ``paths`` a list of node-index
    paths, ``counts`` the target's node count vector (shared by all of a
    target's problems). Returns a list of (coef, rvaf) float64 arrays
    trimmed to each problem's real path count.

    defer=True instead returns a zero-arg ``fetch`` whose call
    materializes that list — the device dispatch has already been
    issued, so the caller can overlap host work (e.g. variant
    naming/sequence materialization) with the solve + readback.
    """
    from ..models.quant import build_contrib, lstsq_fit, ratio_of, \
        refine_fit

    if not problems:
        return (lambda: []) if defer else []

    # the narrowed encodings are exact only within their ranges: float32
    # holds integers exactly below 2^24, int16 occurrence counts below
    # 2^15. A problem outside either range (a k-mer counted > 16.7M
    # times, or one path revisiting a node > 32767 times) routes through
    # the host spec solver instead of being silently perturbed.
    built = []
    host_ix = set()
    for b, (paths, cnt) in enumerate(problems):
        cb = build_contrib(paths, len(cnt))
        built.append(cb)
        if (len(cnt) and np.max(cnt) >= 2 ** 24) or \
                (cb.size and cb.max() >= 2 ** 15):
            host_ix.add(b)

    out: list = [None] * len(problems)
    for b in host_ix:
        cf32 = np.asarray(problems[b][1], dtype=np.float32)
        coef_h = refine_fit(built[b], cf32, lstsq_fit(built[b], cf32))
        out[b] = (np.asarray(coef_h, np.float64),
                  np.asarray(ratio_of(coef_h), np.float64))
    dev_ix = [b for b in range(len(problems)) if b not in host_ix]
    if not dev_ix:
        return (lambda: out) if defer else out

    n_p = [len(problems[b][0]) for b in dev_ix]
    n_n = [len(problems[b][1]) for b in dev_ix]
    P = pad_paths or int(2 ** np.ceil(np.log2(max(max(n_p), 2))))
    N = pad_kmers or int(2 ** np.ceil(np.log2(max(max(n_n), 2))))
    # batch padded to a power of two for stable compile shapes; padding
    # problems are all-zero (zero gradient -> frozen after one step)
    B = int(2 ** np.ceil(np.log2(max(len(dev_ix), 2))))

    contrib = np.zeros((B, N, P), dtype=np.int16)
    counts = np.zeros((B, N), dtype=np.float32)
    coef0 = np.zeros((B, P), dtype=np.float64)
    n_n = n_n + [1] * (B - len(dev_ix))
    for i, b in enumerate(dev_ix):
        cb = built[b]
        cf32 = np.asarray(problems[b][1], dtype=np.float32)
        contrib[i, :n_n[i], :n_p[i]] = cb
        counts[i, :n_n[i]] = cf32  # spec quantifies float32 counts
        # the spec's trajectory start: unconstrained lstsq, then clamp
        start = np.linalg.lstsq(cb, cf32, rcond=None)[0]
        start[start < 0] = 0
        coef0[i, :n_p[i]] = start

    blob = np.concatenate([
        contrib.reshape(-1).view(np.uint32),
        counts.reshape(-1).view(np.uint32),
        coef0.reshape(-1).view(np.uint32),
        np.array(n_n, dtype=np.float64).view(np.uint32)])
    with jax.enable_x64():
        both_dev = _refine_blob(jnp.asarray(blob), B=B, N=N, P=P)

    def fetch():
        both = np.asarray(both_dev, dtype=np.float64)
        coef, rvaf = both[0], both[1]
        for i, b in enumerate(dev_ix):
            out[b] = (coef[i, :n_p[i]], rvaf[i, :n_p[i]])
        return out

    return fetch if defer else fetch()
