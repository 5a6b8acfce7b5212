"""Codon substitution models and the genetic codes.

  GY94 (Goldman-Yang):  Q_ij = kappa^[ts] * omega^[nonsyn] * pi_j for codons
                        that differ at exactly one position
  MG94 (Muse-Gaut):     the target factor is the nucleotide frequency of the
                        changed position instead of the codon frequency; with
                        product-form frequencies (F1X4/F3X4) it is reversible
                        and runs on the same symmetrized eigensystem
  KOSI07 / SCHN05:      empirical 61x61 exchangeabilities (Kosiol et al. 2007
                        ECM; Schneider et al. 2005), shipped as
                        models/data/codon_models.npz

The genetic codes are the NCBI translation tables (codon index = 16 nt1 +
4 nt2 + nt3 with A,C,G,T = 0..3; '*' = stop).  The codon states are a
code's sense codons in index order: 61 for the standard code, 60 to 63
for the others.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional

import numpy as np

from .subst import FREQ_USER, ReversibleModel

_DATA = os.path.join(os.path.dirname(__file__), "data", "codon_models.npz")

# the standard code (NCBI table 1); the other tables as differences
_CODE1 = "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF"
NT_ORDER = "ACGT"


def _codon_index(tri: str) -> int:
    return 16 * NT_ORDER.index(tri[0]) + 4 * NT_ORDER.index(tri[1]) + NT_ORDER.index(tri[2])


def _apply_diffs(base: str, diffs: Dict[str, str]) -> str:
    s = list(base)
    for tri, aa in diffs.items():
        s[_codon_index(tri)] = aa
    return "".join(s)


GENETIC_CODES: Dict[int, str] = {
    1: _CODE1,  # Standard
    # Vertebrate Mitochondrial
    2: _apply_diffs(_CODE1, {"AGA": "*", "AGG": "*", "ATA": "M", "TGA": "W"}),
    # Yeast Mitochondrial
    3: _apply_diffs(_CODE1, {"ATA": "M", "CTA": "T", "CTC": "T", "CTG": "T",
                             "CTT": "T", "TGA": "W"}),
    4: _apply_diffs(_CODE1, {"TGA": "W"}),  # Mold/Protozoan Mitochondrial
    # Invertebrate Mitochondrial
    5: _apply_diffs(_CODE1, {"AGA": "S", "AGG": "S", "ATA": "M", "TGA": "W"}),
    6: _apply_diffs(_CODE1, {"TAA": "Q", "TAG": "Q"}),  # Ciliate Nuclear
    # Echinoderm/Flatworm Mitochondrial
    9: _apply_diffs(_CODE1, {"AAA": "N", "AGA": "S", "AGG": "S", "TGA": "W"}),
    10: _apply_diffs(_CODE1, {"TGA": "C"}),  # Euplotid Nuclear
    11: _CODE1,  # Bacterial/Archaeal/Plant Plastid (start codons differ only)
    # Alternative Flatworm Mitochondrial
    14: _apply_diffs(_CODE1, {"AAA": "N", "AGA": "S", "AGG": "S",
                              "TAA": "Y", "TGA": "W"}),
}


def genetic_code_table(code_id: int = 1) -> str:
    if code_id not in GENETIC_CODES:
        raise ValueError(f"unsupported genetic code table {code_id}")
    return GENETIC_CODES[code_id]


def sense_codons(code_id: int = 1) -> np.ndarray:
    """Codon indices (0..63) of the non-stop codons, in index order."""
    tab = genetic_code_table(code_id)
    return np.array([i for i in range(64) if tab[i] != "*"], dtype=np.int32)


def codon_strings(code_id: int = 1):
    return [NT_ORDER[c // 16] + NT_ORDER[(c // 4) % 4] + NT_ORDER[c % 4]
            for c in sense_codons(code_id)]


_TRANSITIONS = {(0, 2), (2, 0), (1, 3), (3, 1)}  # A<->G, C<->T


def codon_masks(code_id: int = 1):
    """Pairwise structure of the sense-codon space [ns, ns]:
    step       the codons differ at exactly one position
    ts         ... and that change is a transition
    nonsyn     ... and the amino acid changes
    pos        the changed position (0..2; -1 where not a single step)
    target_nt  the target codon's nucleotide at `pos`
    """
    tab = genetic_code_table(code_id)
    sc = sense_codons(code_id)
    ns = len(sc)
    nts = np.stack([sc // 16, (sc // 4) % 4, sc % 4], axis=1)  # [ns, 3]
    diff = nts[:, None, :] != nts[None, :, :]
    step = diff.sum(-1) == 1
    pos = np.where(step, diff.argmax(-1), -1)
    at = np.maximum(pos, 0)[..., None]
    a = np.take_along_axis(np.broadcast_to(nts[:, None, :], (ns, ns, 3)), at, axis=2)[..., 0]
    b = np.take_along_axis(np.broadcast_to(nts[None, :, :], (ns, ns, 3)), at, axis=2)[..., 0]
    ts = step & np.array([[(x, y) in _TRANSITIONS for x, y in zip(ra, rb)]
                          for ra, rb in zip(a, b)])
    aa = np.array([tab[c] for c in sc])
    nonsyn = step & (aa[:, None] != aa[None, :])
    return dict(step=step, ts=ts, nonsyn=nonsyn, pos=pos, target_nt=b)


@dataclass
class CodonModel(ReversibleModel):
    """A parametric codon model; `exchange` follows (kappa, omega).

    mg=True takes the Muse-Gaut target-nucleotide factors (product-form
    frequencies needed).  `nt_freq` [3, 4] holds the position-specific
    nucleotide frequencies (rows equal for F1X4)."""

    code_id: int = 1
    kappa: float = 2.0
    omega: float = 0.3
    mg: bool = False
    nt_freq: Optional[np.ndarray] = None  # [3, 4]
    fix_kappa: bool = False
    fix_omega: bool = False

    def __post_init__(self):
        masks = codon_masks(self.code_id)
        self.step, self.ts, self.nonsyn = masks["step"], masks["ts"], masks["nonsyn"]
        self.pos, self.target_nt = masks["pos"], masks["target_nt"]
        super().__post_init__()
        self.fixed_rates = False
        self.refresh_exchange()

    def mg_factor(self) -> np.ndarray:
        """[ns, ns] symmetric factor that makes Q_ij proportional to the
        target nucleotide's frequency, f_pos(j_pos) / pi_j (product-form pi:
        the other positions' factors of i and j coincide)."""
        pi = np.maximum(np.asarray(self.state_freq, float), 1e-12)
        f = self.nt_freq[np.maximum(self.pos, 0), self.target_nt]
        fac = np.where(self.step, f / pi[None, :], 0.0)
        return 0.5 * (fac + fac.T)

    def refresh_exchange(self) -> None:
        """The exchangeabilities from the current (kappa, omega); called
        after parsing and after the fit writes its values back."""
        r = np.where(self.step, 1.0, 0.0)
        r = r * np.where(self.ts, self.kappa, 1.0)
        r = r * np.where(self.nonsyn, self.omega, 1.0)
        if self.mg and self.nt_freq is not None:
            r = r * self.mg_factor()
        self.exchange = r

    @property
    def n_codon_params(self) -> int:
        return (0 if self.fix_kappa else 1) + (0 if self.fix_omega else 1)


def product_codon_freqs(nt_freq: np.ndarray, code_id: int = 1) -> np.ndarray:
    """Codon frequencies from position-specific nucleotide frequencies
    (F1X4 / F3X4), normalized over the sense codons."""
    sc = sense_codons(code_id)
    pi = nt_freq[0, sc // 16] * nt_freq[1, (sc // 4) % 4] * nt_freq[2, sc % 4]
    return pi / pi.sum()


@lru_cache(maxsize=1)
def _load() -> Dict[str, np.ndarray]:
    return dict(np.load(_DATA))


EMPIRICAL_CODON = {"KOSI07": "ecm_unrest", "ECM": "ecm_unrest", "ECMK07": "ecm_unrest",
                   "ECMREST": "ecm_rest", "SCHN05": "ecm_schn05", "ECMS05": "ecm_schn05"}


def empirical_codon_model(name: str, code_id: int = 1) -> ReversibleModel:
    """KOSI07 (ECM unrestricted), ECMREST and SCHN05 with their published
    frequencies (the standard genetic code only)."""
    if code_id != 1:
        raise ValueError(f"{name} requires the standard genetic code")
    key = EMPIRICAL_CODON.get(name.upper())
    if key is None:
        raise ValueError(f"unknown empirical codon model {name!r}")
    ex = _load()[key + "_exchange"]
    return ReversibleModel(name=name.upper(), num_states=ex.shape[0], exchange=ex,
                           freq_type=FREQ_USER, state_freq=_load()[key + "_freq"].copy(),
                           fixed_rates=True)

