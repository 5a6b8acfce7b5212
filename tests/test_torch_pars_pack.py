"""The parsimony kernel's word arithmetic on the CPU.

csrc/pars_insert.cu packs state sets into lanes of 32-bit words (8
patterns a word as 4-bit sets up to 4 states, one pattern a word up to 32)
and runs Fitch on whole words (SWAR).  The CUDA kernel runs only on the
card; here its packing (`kernel_tip_words`, `kernel_rows`,
`kernel_scratch`), an unpacking written below, and the same integer
formulas, written below with torch integer ops, replay the kernel's walks over every word at once and are
held against the plain Fitch combine `_combine` and the plain twin
`_insertion_costs_plain`: costs exactly equal.  Inputs: example.phy (DNA)
and prot_M126_27_269.phy (20 states: 32-bit sets), a numpy seed for the
insertion order.
"""

import os

import numpy as np
import pytest
import torch

from iqtree_torch.engine import parsimony as pars
from iqtree_torch.io.alignment import read_alignment

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FILES = {"dna": "example.phy", "protein": "prot_M126_27_269.phy"}
U32 = 0xFFFFFFFF


def lane_consts(lanes):
    """(lane width in bits, top bit of every lane) of a word of `lanes`."""
    bits = 32 // lanes
    return bits, (0x88888888 if bits == 4 else 0x80000000)


def nonempty(x, lanes):
    """The kernel's nonempty<B>: each non-empty lane's top bit (uint32 in int64)."""
    _, H = lane_consts(lanes)
    L = ~H & U32
    return ((((x & L) + L) & U32) | x) & H


def swar_fitch(x, y, lanes):
    """The kernel's fitch<B> on words held as uint32 values in int64."""
    bits, _ = lane_consts(lanes)
    i = x & y
    h = nonempty(i, lanes)
    m = h | (h - (h >> (bits - 1)))
    return i | (~m & U32 & (x | y))


def empty_bits(x, lanes):
    """The kernel's empty_bits<B>: bit k set iff lane k of x is empty."""
    bits, H = lane_consts(lanes)
    t = (~nonempty(x, lanes) & H) >> (bits - 1)
    if bits == 4:
        t = (t | (t >> 3)) & 0x03030303
        t = (t | (t >> 6)) & 0x000F000F
        t = (t | (t >> 12)) & 0xFF
    return t


def unpack(words, P, num_states):
    """[N, P] int32 masks from kernel_tip_words' [N, n_words] words."""
    lanes = pars.word_lanes(num_states)
    if lanes == 1:
        return words[:, :P]
    nib = (words.to(torch.int64)[..., None] >> (4 * torch.arange(lanes))) & 0xF
    return nib.reshape(words.shape[0], -1)[:, :P].to(torch.int32)


def walk_costs(words, wts, lanes, leaf, layout, present):
    """The kernel's up and rest walks (kernel_rows, in order) over all words
    at once, its miss bits and the cost kernel's integer sums: [2N] int64."""
    N = words.shape[0]
    rows, n_post = pars.kernel_rows(layout, present)
    val = torch.zeros(2 * N, words.shape[1], dtype=torch.int64)
    val[:N] = words.to(torch.int64) & U32
    rest = torch.zeros_like(val)
    for v, a, b, _ in rows[:n_post]:
        val[v] = swar_fitch(val[a], val[b], lanes)
    cost = torch.zeros(2 * N, dtype=torch.int64)
    k = torch.arange(lanes)
    for v, par, sib, _ in rows[n_post:]:
        rp = torch.full_like(val[0], U32) if par < 0 else rest[par]
        rest[v] = swar_fitch(rp, val[sib], lanes)
        miss = empty_bits(val[leaf] & (val[v] | rest[v]), lanes)  # a byte a word
        hit = (miss[:, None] >> k) & 1  # [n_words, lanes]
        cost[v] = (hit.reshape(-1) * wts.to(torch.int64)).sum()
    return cost


def load(kind):
    aln = read_alignment(os.path.join(DATA, FILES[kind]))
    return aln, torch.as_tensor(pars.pack_tip_masks(aln))


def test_word_lanes():
    assert pars.word_lanes(4) == 8 and pars.word_lanes(2) == 8
    assert pars.word_lanes(5) == 1 and pars.word_lanes(20) == 1
    assert pars.word_lanes(61) == 1 and pars.word_lanes(64) == 1  # one 64-bit lane
    assert [pars.lane_width(S) for S in (4, 5, 32, 33, 61)] == [4, 32, 32, 64, 64]
    with pytest.raises(NotImplementedError, match="up to 64 states"):
        pars.word_lanes(65)


@pytest.mark.parametrize("S,P", [(4, 13), (4, 355), (20, 13)])
def test_pack_unpack_round_trip(S, P):
    """Masks -> kernel words -> masks, P not a multiple of 8; lanes past P
    are empty."""
    rng = np.random.default_rng(P + S)
    masks = torch.as_tensor(rng.integers(1, 1 << S, (7, 1, P)), dtype=torch.int32)
    words = pars.kernel_tip_words(masks, S)
    lanes = pars.word_lanes(S)
    assert words.dtype == torch.int32 and words.shape == (7, -(-P // lanes))
    torch.testing.assert_close(unpack(words, P, S), masks[:, 0])
    if lanes == 8:
        last = words[:, -1].to(torch.int64) & U32
        assert bool(((last >> (4 * (P % 8))) == 0).all())  # padded lanes empty


@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_swar_fitch_matches_combine(kind):
    """Fitch on packed words, unpacked, equals _combine on the masks for
    random pairs of tip and internal-like sets, and the empty-lane bits
    equal _combine's empty intersections."""
    aln, masks = load(kind)
    S, P = aln.num_states, aln.n_patterns
    lanes = pars.word_lanes(S)
    rng = np.random.default_rng(1)
    # the sets of the tips and of the Fitch combines of random tip pairs
    pairs = rng.integers(0, aln.n_taxa, (40, 2))
    inner = pars._combine(masks[pairs[:, 0]], masks[pairs[:, 1]])[0]
    sets = torch.cat([masks, inner])
    words = pars.kernel_tip_words(sets, S).to(torch.int64) & U32
    for _ in range(60):
        i, j = rng.integers(0, len(sets), 2)
        want, empty = pars._combine(sets[i], sets[j])
        got = swar_fitch(words[i], words[j], lanes)
        g32 = torch.where(got >= 2**31, got - 2**32, got).to(torch.int32)
        torch.testing.assert_close(unpack(g32[None], P, S), want)
        bits = empty_bits(words[i] & words[j], lanes)
        hit = ((bits[:, None] >> torch.arange(lanes)) & 1).reshape(-1)[:P]
        torch.testing.assert_close(hit.bool(), empty)


@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_walk_on_words_gives_the_twins_costs(kind):
    """Every insertion of a stepwise-addition tree: the kernel's walk on
    packed words, integer sums of its miss bits, equals the plain twin's
    float64 costs exactly."""
    aln, masks = load(kind)
    N, S = aln.n_taxa, aln.num_states
    freq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64)
    words = pars.kernel_tip_words(masks, S)
    miss, wts = pars.kernel_scratch(words, freq, S)
    assert miss.shape == (2 * N, words.shape[1]) and miss.dtype == torch.uint8
    lanes = pars.word_lanes(S)
    order = [int(t) for t in np.random.default_rng(3).permutation(N)]
    adj = {order[0]: [N], order[1]: [N], order[2]: [N], N: order[:3]}
    nxt = N + 1
    for t in order[3:]:
        layout = pars._partial_layout(adj, order[0], N)
        present = [v for v in adj if v < N]
        want = pars._insertion_costs_plain(masks, freq, t, layout, present)
        got = walk_costs(words, wts, lanes, t, layout, present)
        rows, n_post = pars.kernel_rows(layout, present)
        visited = rows[n_post:, 0]  # the nodes of the pre rows
        np.testing.assert_array_equal(got.numpy()[visited].astype(np.float64),
                                      want[visited])
        v_old = layout[0][int(np.argmin(pars._edge_costs(want, layout)))]
        p_old = pars._adj_parent(adj, order[0], v_old)
        adj[v_old].remove(p_old)
        adj[p_old].remove(v_old)
        adj[v_old].append(nxt)
        adj[p_old].append(nxt)
        adj[nxt] = [v_old, p_old, t]
        adj[t] = [nxt]
        nxt += 1


def test_kernel_scratch_takes_integer_weights_only():
    words = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="integer pattern weights"):
        pars.kernel_scratch(words, torch.tensor([1.0, 2.5, 1.0]), 4)
    miss, wts = pars.kernel_scratch(words, torch.tensor([1.0, 2.0, 3.0]), 4)
    assert wts.tolist() == [1, 2, 3] + [0] * 13 and miss.shape == (8, 2)
