"""Device seed stage vs the host implementation."""
import numpy as np

from yaha_tpu.core import frags as host_frags
from yaha_tpu.ops import seeds_jax


def test_batched_hashes_match_host(genome, test_index):
    rng = np.random.default_rng(4)
    wl = test_index.word_len
    b = 8
    lens = rng.integers(wl + 5, 120, b)
    l = int(lens.max())
    codes = np.full((b, l), 14, np.uint8)  # pad with X (bad) codes
    for k in range(b):
        start = rng.integers(0, len(genome.codes) - lens[k])
        codes[k, :lens[k]] = genome.codes[start:start + lens[k]]
    hashes, clean = seeds_jax.batched_seed_hashes(codes, lens, word_len=wl)
    counts, so_offs = seeds_jax.seed_counts(
        np.asarray(hashes), np.asarray(clean),
        np.asarray(test_index.starting_offs, np.int64))
    counts = np.asarray(counts)
    so_offs = np.asarray(so_offs)
    for k in range(b):
        offs, so_host, cnt_host = host_frags.seed_hits(
            codes[k, :lens[k]], test_index, 650)
        dev_offs = np.flatnonzero(
            (counts[k] > 0) & (counts[k] <= 650) &
            (np.arange(counts.shape[1]) <= lens[k] - wl))
        assert np.array_equal(offs, dev_offs)
        assert np.array_equal(so_host, so_offs[k][dev_offs])
        assert np.array_equal(cnt_host, counts[k][dev_offs])


def test_expand_sort_matches_host_fragments(genome, test_index):
    rng = np.random.default_rng(9)
    wl = test_index.word_len
    b = 6
    lens = rng.integers(60, 150, b)
    l = int(lens.max())
    codes = np.full((b, l), 14, np.uint8)
    for k in range(b):
        start = rng.integers(0, len(genome.codes) - lens[k])
        codes[k, :lens[k]] = genome.codes[start:start + lens[k]]
    hashes, clean = seeds_jax.batched_seed_hashes(codes, lens, word_len=wl)
    counts, so_offs = seeds_jax.seed_counts(
        np.asarray(hashes), np.asarray(clean),
        np.asarray(test_index.starting_offs, np.int64))
    hits, overflow = seeds_jax.expand_and_sort_hits(
        np.asarray(counts), np.asarray(so_offs), test_index.roa, 650, 65536)
    assert not overflow.any()
    for k in range(b):
        offs, so_host, cnt_host = host_frags.seed_hits(
            codes[k, :lens[k]], test_index, 650)
        host = host_frags.find_fragments(offs, so_host, cnt_host,
                                         test_index.roa, wl)
        diag, qo = hits[k]
        # Rebuild fragments from sorted (diag, qo) with boundary rule and
        # compare to the host fragments (the host also injects phantom
        # wrapped-run hits; genome-derived reads rarely hit that path, and
        # this test's reads do not).
        frags = []
        if len(diag):
            brk = np.flatnonzero((np.diff(diag) != 0) |
                                 (np.diff(qo) > wl)) + 1
            starts = np.concatenate([[0], brk])
            ends = np.concatenate([brk - 1, [len(diag) - 1]])
            for s, e in zip(starts, ends):
                sqo = int(qo[s])
                eqo = int(qo[e]) + wl - 1
                frags.append((sqo, eqo, int((diag[s] + sqo) & 0xFFFFFFFF)))
        host_tuples = [(f.sqo, f.eqo, f.sro) for f in host]
        assert frags == host_tuples


def test_wrapped_flags_exact_at_tier_capacity():
    """The phantom-quirk wrapped flags must be EXACT whenever a row's
    total fits the capacity tier — including windows whose expansion
    lies at the very end of the buffer.  Regression: the original
    segment_max formulation produced wrong flags on an accelerator at
    large batch shapes, and tier-1 flags silently under-flagged windows whose whole
    run fell beyond the capacity cutoff (fixed by the prefix-sum
    formulation + tier-2 flags for overflow rows, round 4)."""
    import jax.numpy as jnp
    import numpy as np
    from yaha_tpu.ops import seeds_jax

    wl = 4
    ht = 1 << (2 * wl)
    rng = np.random.default_rng(3)
    # Index: hash h0 -> a large run of non-wrapped hits; hash h1 -> a
    # 2-entry run that is entirely "wrapped" (ro < qo for the window
    # position used below).
    so = np.zeros(ht + 1, np.uint32)
    h0, h1 = 5, 9
    run0, run1 = 40, 2
    counts = np.zeros(ht, np.uint32)
    counts[h0] = run0
    counts[h1] = run1
    so[1:] = np.cumsum(counts).astype(np.uint32)
    roa = np.zeros(int(so[-1]), np.uint32)
    roa[so[h0]:so[h0] + run0] = 10_000 + np.arange(run0, dtype=np.uint32)
    roa[so[h1]:so[h1] + run1] = [1, 2]     # < any realistic qo below
    # One strand row: windows hitting h0 (x3) then h1 LAST, so h1's
    # expansion occupies the final slots of the buffer.
    n_win = 8
    hashes = np.zeros((1, n_win), np.int32)
    clean = np.zeros((1, n_win), bool)
    for w, h in ((0, h0), (2, h0), (4, h0), (6, h1)):
        hashes[0, w] = h
        clean[0, w] = True
    total = 3 * run0 + run1              # 122
    for capacity, expect_overflow in ((64, True), (128, False)):
        out = seeds_jax.expand_sort_hits_device(
            jnp.asarray(hashes), jnp.asarray(clean),
            jnp.asarray(so), jnp.asarray(roa),
            max_hits=650, capacity=capacity)
        assert bool(np.asarray(out["overflow"])[0]) == expect_overflow
        if not expect_overflow:
            wrapped = np.asarray(out["wrapped"])[0]
            # exactly the all-wrapped window (6) is flagged
            assert wrapped[6]
            assert not wrapped[[0, 2, 4]].any()
            assert int(np.asarray(out["total"])[0]) == total
