"""Alignments: PHYLIP/FASTA readers, DNA state encoding, pattern compression.

Host-side (NumPy) data model.  Sites are compressed to unique weighted
patterns; ambiguity codes are kept as integer codes >= num_states with a
code -> state indicator table, so a tip partial is one gather of that
table by the tip codes.

The port reads DNA (4 states), protein (20 states), codons (a genetic
code's sense codons: 61 states for the standard code), binary data (0/1)
and morphology (states 0-9, A-V: up to 32, the count taken from the
highest symbol the data use).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

SEQ_DNA = "DNA"
SEQ_PROTEIN = "AA"
SEQ_BINARY = "BIN"
SEQ_MORPH = "MORPH"
SEQ_CODON = "CODON"

# DNA: states 0..3 = A,C,G,T; ambiguity codes are extra integer codes
# (R=A|G, Y=C|T, W=A|T, S=C|G, M=A|C, K=G|T, B/H/D/V, N/?/-=any).
_DNA_CODES: Dict[str, Tuple[int, ...]] = {
    "A": (0,), "C": (1,), "G": (2,), "T": (3,), "U": (3,),
    "R": (0, 2), "Y": (1, 3), "W": (0, 3), "S": (1, 2),
    "M": (0, 1), "K": (2, 3),
    "B": (1, 2, 3), "H": (0, 1, 3), "D": (0, 2, 3), "V": (0, 1, 2),
    "N": (0, 1, 2, 3), "X": (0, 1, 2, 3), "O": (0, 1, 2, 3),
    "?": (0, 1, 2, 3), "-": (0, 1, 2, 3), ".": (0, 1, 2, 3), "~": (0, 1, 2, 3),
}

# Protein: the 20 states in the reference's order; B=N|D, Z=Q|E, J=I|L,
# U (selenocysteine) as C, X/*/gaps = any.
AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
_AA_CODES: Dict[str, Tuple[int, ...]] = {c: (i,) for i, c in enumerate(AA_ORDER)}
_AA_CODES.update({
    "B": (AA_ORDER.index("N"), AA_ORDER.index("D")),
    "Z": (AA_ORDER.index("Q"), AA_ORDER.index("E")),
    "J": (AA_ORDER.index("I"), AA_ORDER.index("L")),
    "U": (AA_ORDER.index("C"),),
    **{c: tuple(range(20)) for c in "X*?-.~"},
})
_BIN_CODES: Dict[str, Tuple[int, ...]] = {
    "0": (0,), "1": (1,), **{c: (0, 1) for c in "?-.~"},
}
_TABLES = {SEQ_DNA: (_DNA_CODES, 4), SEQ_PROTEIN: (_AA_CODES, 20),
           SEQ_BINARY: (_BIN_CODES, 2)}
# morphology: state i is the i-th symbol; gaps and unknowns allow every state
MORPH_SYMBOLS = "0123456789ABCDEFGHIJKLMNOPQRSTUV"


def _morph_codes(num_states: int) -> Dict[str, Tuple[int, ...]]:
    codes: Dict[str, Tuple[int, ...]] = {MORPH_SYMBOLS[i]: (i,) for i in range(num_states)}
    codes.update({c: tuple(range(num_states)) for c in "?-.~"})
    return codes


def morph_state_count(seqs: List[str]) -> int:
    """States of a morphology alignment: the highest symbol used + 1, at
    least 2 (binary)."""
    used = [MORPH_SYMBOLS.find(ch.upper()) for s in seqs for ch in set(s)]
    return max([1, *used]) + 1


@dataclass
class StateSpace:
    """Maps characters to integer codes and codes to state indicator masks.

    Codes 0..num_states-1 are definite states; further codes are ambiguity
    classes.  `code_masks[c]` is a float [num_states] 0/1 indicator of the
    states consistent with code c; the all-ones row is the unknown code.
    """

    seq_type: str
    num_states: int
    char_to_code: Dict[str, int]
    code_masks: np.ndarray  # [num_codes, num_states] float32
    genetic_code: Optional[int] = None  # codon alignments only
    state_to_codon: Optional[np.ndarray] = None  # [S] codon index 0..63
    codon_to_state: Optional[np.ndarray] = None  # [64]; -1 = stop codon

    @classmethod
    def make(cls, seq_type: str, genetic_code: int = 1,
             num_states: Optional[int] = None) -> "StateSpace":
        """The state space of a sequence type; morphology takes its state
        count (default 2)."""
        if seq_type == SEQ_CODON:
            return cls._make_codon(genetic_code)
        if seq_type == SEQ_MORPH:
            ns = num_states or 2
            table = _morph_codes(ns)
        elif seq_type in _TABLES:
            table, ns = _TABLES[seq_type]
        else:
            raise ValueError(f"unsupported seq type {seq_type}")
        # definite states first, then one code per distinct ambiguity set
        set_to_code: Dict[Tuple[int, ...], int] = {(i,): i for i in range(ns)}
        masks: List[Tuple[int, ...]] = [(i,) for i in range(ns)]
        char_to_code: Dict[str, int] = {}
        for c, states in table.items():
            key = tuple(sorted(states))
            if key not in set_to_code:
                set_to_code[key] = len(masks)
                masks.append(key)
            char_to_code[c] = set_to_code[key]
        m = np.zeros((len(masks), ns), dtype=np.float32)
        for code, states in enumerate(masks):
            m[code, list(states)] = 1.0
        return cls(seq_type, ns, char_to_code, m)

    @classmethod
    def _make_codon(cls, genetic_code: int) -> "StateSpace":
        """The sense codons of a genetic code in index order, and one
        unknown code (any triplet with a gap or an ambiguity)."""
        from ..models.codon import sense_codons

        sc = sense_codons(genetic_code)
        ns = len(sc)
        codon_to_state = np.full(64, -1, dtype=np.int32)
        codon_to_state[sc] = np.arange(ns, dtype=np.int32)
        masks = np.concatenate([np.eye(ns, dtype=np.float32), np.ones((1, ns), np.float32)])
        return cls(SEQ_CODON, ns, {"?": ns}, masks, genetic_code=genetic_code,
                   state_to_codon=sc, codon_to_state=codon_to_state)

    def encode(self, seq: str) -> np.ndarray:
        if self.seq_type == SEQ_CODON:
            return self._encode_codon(seq)
        out = np.empty(len(seq), dtype=np.int32)
        c2c = self.char_to_code
        for i, ch in enumerate(seq):
            code = c2c.get(ch.upper())
            if code is None:
                raise ValueError(f"invalid character {ch!r} for {self.seq_type}")
            out[i] = code
        return out

    def _encode_codon(self, seq: str) -> np.ndarray:
        """Triplets of definite nucleotides -> codon states; a gap or an
        ambiguity in a triplet makes it unknown; a stop codon is an error."""
        if len(seq) % 3 != 0:
            raise ValueError(f"codon sequence length {len(seq)} is not a multiple of 3")
        nt = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}
        out = np.empty(len(seq) // 3, dtype=np.int32)
        for i in range(0, len(seq), 3):
            tri = seq[i:i + 3].upper()
            a, b, c = nt.get(tri[0]), nt.get(tri[1]), nt.get(tri[2])
            if a is None or b is None or c is None:
                out[i // 3] = self.num_states
                continue
            st = self.codon_to_state[16 * a + 4 * b + c]
            if st < 0:
                raise ValueError(f"stop codon {tri} at nucleotide position {i + 1}")
            out[i // 3] = st
        return out


def detect_seq_type(seqs: List[str]) -> str:
    """Character-share heuristic: binary (0/1) or morphology (digits) above
    90% of the definite characters, DNA when more than 85% are A/C/G/T/U,
    else protein."""
    counts: Dict[str, int] = {}
    total = 0
    for s in seqs:
        for ch in s.upper():
            if ch in "?-.~NX":
                continue
            counts[ch] = counts.get(ch, 0) + 1
            total += 1
    if total == 0:
        return SEQ_DNA
    dna = sum(counts.get(c, 0) for c in "ACGTU")
    if sum(counts.get(c, 0) for c in "01") / total > 0.9:
        return SEQ_BINARY
    if sum(counts.get(c, 0) for c in "0123456789") / total > 0.9:
        return SEQ_MORPH
    return SEQ_DNA if dna / total > 0.85 else SEQ_PROTEIN


@dataclass
class Alignment:
    """Pattern-compressed multiple sequence alignment.

    patterns:     int32 [n_taxa, n_patterns] integer codes
    pattern_freq: float64 [n_patterns] site counts per pattern
    site_to_pattern: int32 [n_sites]
    const_state:  int32 [n_patterns]; -1 = not invariant-compatible,
                  num_states = all-unknown column, else the constant state
    """

    names: List[str]
    patterns: np.ndarray
    pattern_freq: np.ndarray
    site_to_pattern: np.ndarray
    states: StateSpace

    @property
    def n_taxa(self) -> int:
        return self.patterns.shape[0]

    @property
    def n_patterns(self) -> int:
        return self.patterns.shape[1]

    @property
    def n_sites(self) -> int:
        return int(self.site_to_pattern.shape[0])

    @property
    def num_states(self) -> int:
        return self.states.num_states

    @property
    def const_state(self) -> np.ndarray:
        return self._const_state

    def __post_init__(self):
        inter = self.states.code_masks[self.patterns].min(axis=0)  # [ptn, S]
        count = inter.sum(axis=1)
        ns = self.num_states
        const_state = np.full(self.n_patterns, -1, dtype=np.int32)
        const_state[count == ns] = ns
        single = count == 1
        const_state[single] = inter[single].argmax(axis=1)
        self._const_state = const_state

    def state_frequencies(self) -> np.ndarray:
        """Empirical state frequencies (+F): 8 rounds of distributing each
        (possibly ambiguous) character over its consistent states in
        proportion to the current estimate, then a floor at 1e-4 with the
        residual put on the most frequent state."""
        S = self.num_states
        masks = self.states.code_masks
        counts = np.bincount(
            self.patterns.ravel(),
            weights=np.broadcast_to(self.pattern_freq, self.patterns.shape).ravel(),
            minlength=masks.shape[0],
        )
        freq = np.full(S, 1.0 / S)
        for _ in range(8):
            w = freq[None, :] * masks
            w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
            new = (w * counts[:, None]).sum(axis=0)
            freq = new / new.sum()
        min_freq = 1e-4
        freq[freq < min_freq] = min_freq
        freq[np.argmax(freq)] += 1.0 - freq.sum()
        return freq

    def frac_const_sites(self) -> float:
        """Share of sites whose pattern is constant (or all unknown)."""
        return float(self.pattern_freq[self.const_state >= 0].sum()
                     / self.pattern_freq.sum())

    def num_informative_sites(self) -> int:
        """Parsimony-informative sites: at least two states that each
        appear in at least two taxa (an ambiguous character counts toward
        every state it allows; an all-unknown one toward none)."""
        masks = self.states.code_masks[self.patterns]  # [taxa, ptn, S]
        known = masks.sum(axis=2) < self.num_states
        app = (masks * known[:, :, None]).sum(axis=0)  # [ptn, S]
        informative = (app >= 2).sum(axis=1) >= 2
        return int(self.pattern_freq[informative].sum())

    def codon_nt_frequencies(self, by_position: bool = True) -> np.ndarray:
        """[3, 4] nucleotide frequencies at each codon position of the
        definite codons (F3X4); with by_position=False the three rows are
        the pooled counts (F1X4)."""
        if self.states.seq_type != SEQ_CODON:
            raise ValueError("codon nucleotide frequencies need codon data")
        sc = self.states.state_to_codon
        ns = self.num_states
        w = np.broadcast_to(self.pattern_freq, self.patterns.shape)
        known = self.patterns < ns
        codons = sc[np.where(known, self.patterns, 0)][known]
        w = w[known]
        counts = np.stack([np.bincount(d, weights=w, minlength=4)
                           for d in (codons // 16, (codons // 4) % 4, codons % 4)])
        if not by_position:
            counts = np.broadcast_to(counts.sum(0), (3, 4)).copy()
        counts = np.maximum(counts, 1e-6)
        return counts / counts.sum(axis=1, keepdims=True)

    def identical_groups(self):
        """(keep, removed_pairs): the taxon indices to analyse, and
        (removed_name, twin_name) for each sequence identical to an
        earlier one."""
        seen = {}
        keep = []
        pairs = []
        for i in range(self.n_taxa):
            key = self.patterns[i].tobytes()
            j = seen.get(key)
            if j is None:
                seen[key] = i
                keep.append(i)
            else:
                pairs.append((self.names[i], self.names[j]))
        return keep, pairs

    def subset_taxa(self, keep) -> "Alignment":
        """The alignment of the given taxa (patterns re-compressed:
        dropping rows can merge columns)."""
        cols = self.patterns[np.ix_(keep, self.site_to_pattern)]
        uniq, s2p, counts = np.unique(
            np.ascontiguousarray(cols.T), axis=0,
            return_inverse=True, return_counts=True)
        return Alignment(
            names=[self.names[i] for i in keep],
            patterns=np.ascontiguousarray(uniq.T).astype(np.int32),
            pattern_freq=counts.astype(np.float64),
            site_to_pattern=s2p.reshape(-1).astype(np.int32),
            states=self.states)

    @classmethod
    def from_sequences(
        cls,
        names: List[str],
        seqs: List[str],
        seq_type: Optional[str] = None,
        genetic_code: int = 1,
    ) -> "Alignment":
        if len(set(len(s) for s in seqs)) != 1:
            lens = {n: len(s) for n, s in zip(names, seqs)}
            raise ValueError(f"sequences have unequal lengths: {lens}")
        if seq_type is None:
            seq_type = detect_seq_type(seqs)
        num_states = morph_state_count(seqs) if seq_type == SEQ_MORPH else None
        states = StateSpace.make(seq_type, genetic_code, num_states)
        mat = np.stack([states.encode(s) for s in seqs])  # [taxa, sites]
        uniq, site_to_pattern, counts = np.unique(
            np.ascontiguousarray(mat.T), axis=0,
            return_inverse=True, return_counts=True,
        )
        return cls(
            names=list(names),
            patterns=np.ascontiguousarray(uniq.T).astype(np.int32),
            pattern_freq=counts.astype(np.float64),
            site_to_pattern=site_to_pattern.reshape(-1).astype(np.int32),
            states=states,
        )


def read_alignment(path: str, seq_type: Optional[str] = None,
                   genetic_code: int = 1) -> Alignment:
    """Read a PHYLIP (sequential or interleaved) or FASTA alignment; codon
    data (seq_type CODON) under the given NCBI genetic code."""
    with open(path) as f:
        text = f.read()
    if not text.strip():
        raise ValueError(f"alignment file {path} is empty")
    head = text.lstrip()[:10].upper()
    if head.startswith(">"):
        names, seqs = _read_fasta(text)
    elif head.startswith(("#NEXUS", "CLUSTAL")):
        raise NotImplementedError(
            "NEXUS/CLUSTAL input is not ported yet; convert to PHYLIP or FASTA")
    else:
        names, seqs = _read_phylip(text)
    return Alignment.from_sequences(names, seqs, seq_type, genetic_code)


def _read_fasta(text: str):
    names, seqs, cur = [], [], []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if cur:
                seqs.append("".join(cur))
                cur = []
            names.append(line[1:].split()[0])
        else:
            cur.append(line.replace(" ", ""))
    if cur:
        seqs.append("".join(cur))
    if not names:
        raise ValueError("empty FASTA file")
    return names, seqs


def _read_phylip(text: str):
    lines = [l for l in text.splitlines() if l.strip()]
    m = re.match(r"\s*(\d+)\s+(\d+)", lines[0])
    if not m:
        raise ValueError("bad PHYLIP header")
    ntax, nsites = int(m.group(1)), int(m.group(2))
    names: List[str] = []
    seqs: List[List[str]] = []
    idx = 0
    for line in lines[1:]:
        if len(names) < ntax:
            parts = line.split(None, 1)
            name, rest = (parts[0], "") if len(parts) == 1 else parts
            names.append(name)
            seqs.append([rest.replace(" ", "")])
        else:  # interleaved continuation
            seqs[idx % ntax].append(line.replace(" ", ""))
            idx += 1
    out = ["".join(chunks) for chunks in seqs]
    for n, s in zip(names, out):
        if len(s) != nsites:
            raise ValueError(f"sequence {n}: {len(s)} chars, expected {nsites}")
    return names, out
