"""NEXUS `models` block parser (the built-in mixture definitions).

Reads models/data/builtin_mixmodels.nex, the mixtures IQ-TREE ships (EX2,
EX3, EHO, UL2, UL3, EX_EHO, LG4M, LG4X, CF4, CAT C10..C60).  Grammar
(square-bracket comments stripped):

    begin models;
      frequency NAME = f1 f2 ... fS;
      model NAME = x21
                   x31 x32
                   ...            [ lower-triangular exchangeabilities ]
                   f1 f2 ... fS;  [ optional state frequencies ]
      model NAME = EXPR;          [ e.g. MIX{A:1.2,B}, POISSON+G+FMIX{..} ]
    end;
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

_DATA = Path(__file__).resolve().parent.parent / "models/data/builtin_mixmodels.nex"


@dataclass
class MatrixDef:
    """A full rate-matrix definition (exchangeabilities + frequencies)."""

    name: str
    exchange: np.ndarray  # [S, S] symmetric, zero diagonal
    freqs: Optional[np.ndarray]  # [S] or None


@dataclass
class FreqDef:
    name: str
    freqs: np.ndarray  # [S]


@dataclass
class ExprDef:
    name: str
    expr: str  # model-string expression, e.g. "MIX{BurEX2:0.67,ExpEX2:1.64}"


def _strip_comments(text: str) -> str:
    return re.sub(r"\[[^\]]*\]", " ", text)


def parse_models_nexus(text: str) -> Dict[str, object]:
    """Parse every `models` block; returns {NAME: MatrixDef|FreqDef|ExprDef}
    with names case-normalized to upper for lookup (original kept inside)."""
    text = _strip_comments(text)
    defs: Dict[str, object] = {}
    for block in re.findall(
        r"begin\s+models\s*;(.*?)end\s*;", text, re.IGNORECASE | re.DOTALL
    ):
        for stmt in block.split(";"):
            stmt = stmt.strip()
            if not stmt:
                continue
            m = re.match(r"(model|frequency)\s+(\S+)\s*=\s*(.*)", stmt,
                         re.IGNORECASE | re.DOTALL)
            if not m:
                continue
            kind, name, body = m.group(1).lower(), m.group(2), m.group(3)
            body = body.strip()
            if kind == "frequency":
                vals = np.array([float(x) for x in body.split()])
                defs[name.upper()] = FreqDef(name, vals / vals.sum())
                continue
            # model: numeric lower-triangle or expression?
            if re.fullmatch(r"[\s0-9.eE+-]+", body):
                nums = [float(x) for x in body.split()]
                defs[name.upper()] = _matrix_def(name, nums)
            else:
                defs[name.upper()] = ExprDef(name, body.replace(" ", ""))
    return defs


def _matrix_def(name: str, nums: List[float]) -> MatrixDef:
    """n = S(S-1)/2 (+ S if frequencies appended) numbers."""
    n = len(nums)
    # solve S(S-1)/2 == n  or  S(S-1)/2 + S == n; both can hold (e.g.
    # 210 = C(21,2) = C(20,2)+20), so when the with-frequencies reading
    # is consistent (tail sums to ~1) prefer it
    s_nofreq = (1 + math.isqrt(1 + 8 * n)) // 2
    s_freq = (-1 + math.isqrt(9 + 8 * n)) // 2
    freq_ok = (
        s_freq * (s_freq - 1) // 2 + s_freq == n
        and abs(sum(nums[-s_freq:]) - 1.0) < 1e-2
    )
    if freq_ok:
        S, has_freq = s_freq, True
    elif s_nofreq * (s_nofreq - 1) // 2 == n:
        S, has_freq = s_nofreq, False
    elif s_freq * (s_freq - 1) // 2 + s_freq == n:
        S, has_freq = s_freq, True
    else:
        raise ValueError(
            f"model {name}: {n} numbers do not form a lower triangle"
        )
    ex = np.zeros((S, S))
    k = 0
    for i in range(1, S):
        for j in range(i):
            ex[i, j] = ex[j, i] = nums[k]
            k += 1
    freqs = None
    if has_freq:
        f = np.asarray(nums[k:])
        freqs = f / f.sum()
    return MatrixDef(name, ex, freqs)


_BUILTIN_CACHE: Optional[Dict[str, object]] = None


def builtin_mixture_defs() -> Dict[str, object]:
    """Builtin mixture definitions (EX2/EX3/EHO/EX_EHO, LG4M/LG4X, CF4,
    CAT C10..C60) shipped as data in models/data/builtin_mixmodels.nex."""
    global _BUILTIN_CACHE
    if _BUILTIN_CACHE is None:
        _BUILTIN_CACHE = parse_models_nexus(_DATA.read_text())
    return _BUILTIN_CACHE
