"""Empirical amino-acid substitution models.

19 published replacement matrices (Dayhoff, JTT, WAG, LG, VT, PMB,
Blosum62, DCMut, JTTDCMut, mtREV/mtMAM/mtART/mtZOA, cpREV, HIVb/HIVw,
FLU, rtREV, Poisson) shipped as data (models/data/protein_models.npz:
the exchangeabilities `<NAME>_rates` [20, 20] and the published
frequencies `<NAME>_freq` [20], states in the order ARNDCQEGHILKMFPSTWYV).

By default empirical models use their published frequencies; +F switches
to alignment counts, +FO to ML estimation.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np

from .subst import FREQ_USER, ReversibleModel

_DATA = os.path.join(os.path.dirname(__file__), "data", "protein_models.npz")

# accepted aliases (upper-case) -> key in the data file
ALIASES: Dict[str, str] = {
    "POISSON": "POISSON",
    "DAYHOFF": "DAYHOFF",
    "PAM": "DAYHOFF",
    "DCMUT": "DCMUT",
    "JTT": "JTT",
    "JTTDCMUT": "JTTDCMUT",
    "JTTDCMU": "JTTDCMUT",
    "MTREV": "MTREV",
    "MTREV24": "MTREV",
    "WAG": "WAG",
    "RTREV": "RTREV",
    "CPREV": "CPREV",
    "CPREV64": "CPREV",
    "VT": "VT",
    "BLOSUM62": "BLOSUM62",
    "MTMAM": "MTMAM",
    "LG": "LG",
    "MTART": "MTART",
    "MTZOA": "MTZOA",
    "PMB": "PMB",
    "HIVB": "HIVB",
    "HIVW": "HIVW",
    "FLU": "FLU",
}

PROTEIN_MODEL_NAMES = sorted(set(ALIASES.values()))


@lru_cache(maxsize=1)
def _load() -> Dict[str, np.ndarray]:
    return dict(np.load(_DATA))


def protein_exchange_and_freq(name: str) -> Tuple[np.ndarray, np.ndarray]:
    key = ALIASES.get(name.upper())
    if key is None:
        raise ValueError(f"unknown protein model {name!r}")
    data = _load()
    return data[f"{key}_rates"].copy(), data[f"{key}_freq"].copy()


def create_protein_model(name: str) -> ReversibleModel:
    rates, freq = protein_exchange_and_freq(name)
    return ReversibleModel(
        name=ALIASES[name.upper()],
        num_states=20,
        exchange=rates,
        freq_type=FREQ_USER,  # published model frequencies by default
        state_freq=freq,
        fixed_rates=True,
    )
