"""Valence-aware SMILES validity — the no-RDKit fallback tier (the port's
own copy of the JAX package's `design/valence.py`, pure Python; the two
agree string for string, tests/test_torch_data_copies.py).

The reference defines validity as "RDKit parses it"
(`generative.py:954-961`).  Without RDKit, a grammar-only check passes
chemically impossible strings (pentavalent carbon, divalent fluorine),
inflating validity fractions.  This module implements the chemistry RDKit
applies at parse time for the organic subset:

  * full SMILES parse: organic-subset + bracket atoms (isotope, H-count,
    charge, chirality), bonds (- = # : / \\), branches, ring closures
    (shared-digit reuse, %nn), dot-separated fragments;
  * kekulization of aromatic systems: every aromatic atom must sit in a
    ring of the aromatic subgraph, and the pi-needy atoms (aromatic C
    without an exocyclic multiple bond; pyridine-type N, incl. charged
    pyridinium [nH+]/[n+]) must admit a perfect matching of alternating
    double bonds — pyrrole-type n[H]/3-connected neutral n, and o/s,
    contribute lone pairs instead;
  * Hückel 4n+2 electron count: every aromatic atom must lie on at least
    one simple cycle of the aromatic subgraph whose pi-electron sum is
    4n+2 (benzene 6, azulene's 10-perimeter, naphthalene's 6-rings) —
    this is what rejects antiaromatic spellings RDKit rejects
    (cyclobutadiene "c1ccc1", aromatic COT "c1ccccccc1") and aromatic
    bonds outside any ring ("c1ccccc1cc1ccccc1");
  * valence check per atom against the allowed-valence table (charge-
    adjusted): organic-subset atoms may fill up with implicit hydrogens
    (valid iff bond-order sum <= max allowed), bracket atoms are exact
    (bond sum + explicit H must hit an allowed valence).  Main-group
    bracket elements beyond the organic table (Si, Na, Mg, Al, Se, As,
    Te, ...) are checked against RDKit's default-valence model with its
    effective-valence charge rule (charge sign flips for early atoms),
    so "[Na+]"/"[SiH4]" are accepted but "[SiH8]"/"[MgH6]"/"C[Na](C)C"
    are rejected exactly as RDKit rejects them.  Only elements RDKit
    itself leaves unchecked (default valence -1: transition metals,
    lanthanides/actinides) are accepted with unconstrained valence, so
    "[Fe+2]" and "Cl[Fe]Cl" parse exactly as RDKit parses them.

Known approximations vs RDKit (cross-validated on the annotated corpus in
tests/rdkit_corpus.py — zero divergences ON THAT CORPUS; the corpus is
finite, so off-corpus edge cases may still differ): the Hückel analysis
enumerates ALL simple cycles (RDKit reasons over its perceived ring set)
under a fixed work budget — pathological dense aromatic graphs that
exhaust the budget are accepted permissively.  QM9-alphabet traffic never
constructs such systems; when RDKit is present it wins anyway
(`smiles_is_valid`).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# charge-adjusted allowed valences (RDKit default valence model for the
# organic subset; tuples = multi-valent elements)
_VALENCES: Dict[Tuple[str, int], Tuple[int, ...]] = {
    ("B", 0): (3,), ("B", -1): (4,),
    ("C", 0): (4,), ("C", 1): (3,), ("C", -1): (3,),
    ("N", 0): (3,), ("N", 1): (4,), ("N", -1): (2,),
    ("O", 0): (2,), ("O", 1): (3,), ("O", -1): (1,),
    ("F", 0): (1,), ("F", -1): (0,),
    ("P", 0): (3, 5), ("P", 1): (4,),
    ("S", 0): (2, 4, 6), ("S", 1): (3, 5), ("S", -1): (1,),
    ("Cl", 0): (1,), ("Cl", -1): (0,),
    ("Br", 0): (1,), ("Br", -1): (0,),
    ("I", 0): (1,), ("I", -1): (0,),
    ("H", 0): (1,), ("H", 1): (0,), ("H", -1): (0,),
}
_AROMATIC_OK = {"b", "c", "n", "o", "p", "s"}
_LONE_PAIR_AROMATIC = {"o", "s"}          # contribute the pair, never a pi

# RDKit default valences for main-group elements beyond the organic/
# halogen table above (RDKit atomic_data defaults).  These ARE
# valence-checked by RDKit — the unchecked default-valence -1 set is only
# the transition metals and lanthanides/actinides (everything real that
# appears in neither table).  Charges are handled by RDKit's
# effective-valence rule (see `_EARLY_ELEMENTS`), not per-charge rows.
_MAIN_GROUP_VALENCES: Dict[str, Tuple[int, ...]] = {
    "Li": (1,), "Be": (2,), "Na": (1,), "Mg": (2,), "K": (1,), "Ca": (2,),
    "Rb": (1,), "Sr": (2,), "Cs": (1,), "Ba": (2,), "Fr": (1,), "Ra": (2,),
    "Al": (3,), "Ga": (3,), "In": (3,), "Tl": (1, 3),
    "Si": (4,), "Ge": (4,), "Sn": (2, 4), "Pb": (2, 4),
    "As": (3, 5), "Sb": (3, 5), "Bi": (3, 5),
    "Se": (2, 4, 6), "Te": (2, 4, 6), "Po": (2, 4, 6), "At": (1,),
    "He": (0,), "Ne": (0,), "Ar": (0,), "Kr": (0,), "Xe": (0, 2, 4, 6),
    "Rn": (0,),
}
# "Early" atoms in RDKit's sense (fewer than 4 outer electrons, H/He
# excepted): the formal-charge sign FLIPS in the effective-valence
# computation, so [Na+]/[Mg+2]/[AlH4-] pass while C[Na](C)C fails.
_EARLY_ELEMENTS = frozenset(
    "Li Be Na Mg K Ca Rb Sr Cs Ba Fr Ra Al Ga In Tl".split())

# All IUPAC element symbols.  Bracket atoms whose element is real but
# absent from BOTH valence tables (transition metals, lanthanides,
# actinides) get RDKit's default valence -1 treatment: any bond sum is
# accepted.
_ELEMENTS = frozenset(
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe "
    "Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In "
    "Sn Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf "
    "Ta W Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am "
    "Cm Bk Cf Es Fm Md No Lr Rf Db Sg Bh Hs Mt Ds Rg Cn Nh Fl Mc Lv Ts "
    "Og".split())
# elements the valence table DOES cover — for these, an unlisted charge
# state stays a rejection (e.g. [NH4] neutral, [CH4+]), never permissive
_TABLE_ELEMENTS = frozenset(e for e, _ in _VALENCES)

_BRACKET_RE = re.compile(
    r"^(?P<iso>\d+)?(?P<sym>[A-Z][a-z]?|[bcnops])(?P<chi>@{1,2})?"
    r"(?P<h>H\d*)?(?P<chg>\+{1,3}|-{1,3}|\+\d|-\d)?$")
_BOND_ORDER = {"-": 1, "=": 2, "#": 3, "/": 1, "\\": 1, ":": None}


@dataclass
class _Atom:
    element: str
    aromatic: bool
    charge: int = 0
    explicit_h: Optional[int] = None      # None = organic subset (implicit)
    bonds: List[Tuple[int, Optional[int]]] = field(default_factory=list)
    # bond order None = aromatic (to be kekulized)


def _parse_bracket(body: str) -> Optional[_Atom]:
    m = _BRACKET_RE.match(body)
    if not m:
        return None
    sym = m.group("sym")
    aromatic = sym[0].islower()
    element = sym.capitalize() if aromatic else sym
    if aromatic and sym not in _AROMATIC_OK:
        return None
    h = m.group("h")
    hcount = 0 if h is None else (1 if h == "H" else int(h[1:]))
    chg = m.group("chg") or ""
    if chg and chg[-1].isdigit():
        charge = int(chg[1:]) * (1 if chg[0] == "+" else -1)
    else:
        charge = chg.count("+") - chg.count("-")
    return _Atom(element, aromatic, charge, hcount)


def _tokenize_parse(smi: str) -> Optional[List[_Atom]]:
    """Parse into an atom/bond graph; None on any grammar violation."""
    atoms: List[_Atom] = []
    prev: Optional[int] = None
    stack: List[Optional[int]] = []
    pending: Optional[str] = None         # explicit bond symbol awaiting use
    rings: Dict[str, Tuple[int, Optional[str]]] = {}
    i, n = 0, len(smi)

    def add_bond(a: int, b: int, sym: Optional[str]) -> bool:
        if a == b:
            return False
        if sym == ":" or (sym is None and atoms[a].aromatic
                          and atoms[b].aromatic):
            order: Optional[int] = None   # aromatic
        else:
            order = 1 if sym is None else _BOND_ORDER[sym]
        if any(o == b for o, _ in atoms[a].bonds):
            return False                  # duplicate bond
        atoms[a].bonds.append((b, order))
        atoms[b].bonds.append((a, order))
        return True

    def new_atom(atom: _Atom) -> bool:
        nonlocal prev, pending
        atoms.append(atom)
        idx = len(atoms) - 1
        if prev is not None:
            if not add_bond(prev, idx, pending):
                return False
        elif pending is not None:
            return False                  # bond with no left atom
        pending = None
        prev = idx
        return True

    while i < n:
        ch = smi[i]
        if ch == "[":
            j = smi.find("]", i)
            if j < 0:
                return None
            atom = _parse_bracket(smi[i + 1:j])
            if atom is None or not new_atom(atom):
                return None
            i = j + 1
        elif smi.startswith(("Cl", "Br"), i):
            if not new_atom(_Atom(smi[i:i + 2], False)):
                return None
            i += 2
        elif ch in "BCNOPSFI":
            if not new_atom(_Atom(ch, False)):
                return None
            i += 1
        elif ch in "bcnops":
            if not new_atom(_Atom(ch.upper(), True)):
                return None
            i += 1
        elif ch in _BOND_ORDER:
            if pending is not None:
                return None
            pending = ch
            i += 1
        elif ch == "(":
            if prev is None:
                return None
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack or pending is not None:
                return None
            prev = stack.pop()
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                if i + 2 >= n or not smi[i + 1:i + 3].isdigit():
                    return None
                label, i = smi[i + 1:i + 3], i + 3
            else:
                label, i = ch, i + 1
            if prev is None:
                return None
            if label in rings:
                open_atom, open_sym = rings.pop(label)
                sym = pending if pending is not None else open_sym
                if (pending is not None and open_sym is not None
                        and pending != open_sym):
                    return None           # contradictory closure bonds
                if not add_bond(open_atom, prev, sym):
                    return None
                pending = None
            else:
                rings[label] = (prev, pending)
                pending = None
        elif ch == ".":
            if pending is not None or prev is None:
                return None               # empty fragment / leading dot
            prev = None
            i += 1
        else:
            return None
    if stack or rings or pending is not None or not atoms:
        return None
    if prev is None:                      # trailing dot: "C."
        return None
    return atoms


def _pi_contribution(a: _Atom) -> int:
    """Electrons the atom donates to an aromatic ring's pi system (the
    standard Hückel bookkeeping RDKit's aromaticity model applies)."""
    elem = a.element.lower()
    if any(order is not None and order >= 2 for _, order in a.bonds):
        return 0                          # exocyclic multiple bond (c=O)
    if elem in _LONE_PAIR_AROMATIC:
        if a.charge > 0:
            return 1                      # pyrylium/thiopyrylium [o+]/[s+]
        return 2                          # neutral o / s: the lone pair
    if elem in ("n", "p"):
        if a.charge > 0:
            return 1                      # pyridinium-type
        degree = len(a.bonds) + (a.explicit_h or 0)
        if (a.explicit_h or 0) > 0 or degree >= 3 or a.charge < 0:
            return 2                      # pyrrole-type lone pair
        return 1                          # pyridine-type
    if a.charge > 0:
        return 0                          # tropylium-type empty orbital
    if a.charge < 0:
        return 2                          # cyclopentadienyl-type pair
    if elem == "b":
        return 0                          # neutral boron: empty p orbital
    return 1                              # aromatic C


# DFS edge-visit budget per aromatic component for the Hückel cycle
# enumeration.  Molecule-like graphs (max degree 3, planar-ish fusion)
# finish in <<1 ms well beyond any SMILES-spellable aromatic system;
# only dense adversarial graphs exhaust it (measured: coronene ~3k
# visits, a 40-annulene ~100 visits).
_HUCKEL_BUDGET = 200_000


def _huckel_ok(atoms: List[_Atom], aro_adj: Dict[int, List[int]]) -> bool:
    """Hückel 4n+2 test: every aromatic atom must lie on at least one
    simple cycle of the aromatic subgraph whose pi-electron sum is 4n+2.

    Enumerating ALL simple cycles (not just an SSSR) is what lets
    azulene pass via its 10-atom perimeter while its 5- and 7-rings
    individually fail — matching RDKit's fused-ring-system analysis for
    every molecule the QM9 alphabet can spell.  Aromatic subgraphs in
    real traffic are tiny (<=~20 atoms) and molecule-like graphs (max
    degree 3) keep the cycle count small even at macrocycle sizes, so a
    [28]annulene is correctly rejected (4n pi) rather than size-guarded
    into acceptance.  The enumeration runs under a fixed WORK budget
    (`_HUCKEL_BUDGET` DFS edge visits per component): only pathological
    dense aromatic graphs (e.g. fullerene-like cages, whose simple-cycle
    count is astronomical) exhaust it and fall back to accepting (never
    rejecting), so an adversarial input cannot blow up the checker.
    """
    contrib = {i: _pi_contribution(atoms[i]) for i in aro_adj}
    justified: set = set()
    seen: set = set()
    for root in aro_adj:
        if root in seen:
            continue
        comp = [root]
        seen.add(root)
        qi = 0
        while qi < len(comp):
            for w in aro_adj[comp[qi]]:
                if w not in seen:
                    seen.add(w)
                    comp.append(w)
            qi += 1
        # DFS cycle enumeration: each cycle found once per direction with
        # its minimum-index atom as the start (standard canonicalization);
        # bounded by a work budget so dense pathological graphs cannot
        # blow up (see docstring)
        budget = [_HUCKEL_BUDGET]

        def dfs(start: int, v: int, path: List[int], on_path: set) -> None:
            for w in aro_adj[v]:
                if budget[0] <= 0:
                    return
                budget[0] -= 1
                if w == start and len(path) >= 3:
                    if sum(contrib[i] for i in path) % 4 == 2:
                        justified.update(path)
                elif w > start and w not in on_path:
                    path.append(w)
                    on_path.add(w)
                    dfs(start, w, path, on_path)
                    path.pop()
                    on_path.remove(w)

        for s in sorted(comp):
            dfs(s, s, [s], {s})
            if budget[0] <= 0:
                break
        if budget[0] <= 0:                # guard: accept, never reject
            justified.update(comp)
    return all(i in justified for i in aro_adj)


def _kekulize(atoms: List[_Atom]) -> bool:
    """Assign alternating double bonds over the aromatic subgraph; True if
    a consistent assignment exists (orders are written back in place)."""
    aro_adj: Dict[int, List[int]] = {}
    for idx, a in enumerate(atoms):
        nbrs = [o for o, order in a.bonds if order is None]
        if a.aromatic or nbrs:
            if not a.aromatic:
                return False              # aromatic bond to aliphatic atom
            aro_adj[idx] = nbrs
    if not aro_adj:
        return True
    # every aromatic atom must sit in the aromatic subgraph's cycle space:
    # >=2 aromatic neighbors (an aromatic atom dangling off a chain is not
    # a molecule RDKit accepts)
    for idx in aro_adj:
        if len(aro_adj[idx]) < 2:
            return False
    if not _huckel_ok(atoms, aro_adj):
        return False

    def needs_pi(idx: int) -> bool:
        a = atoms[idx]
        elem = a.element.lower()
        if elem in _LONE_PAIR_AROMATIC:
            # pyrylium-type [o+]/[s+] keeps its pi bond (the asymmetric
            # counterpart of pyridinium); neutral o/s donate the lone pair
            return a.charge > 0
        if any(order is not None and order >= 2 for _, order in a.bonds):
            return False                  # exocyclic multiple bond covers it
        if elem == "n" or elem == "p":
            if a.charge > 0:
                return True               # pyridinium-type [nH+]/[n+](R):
                                          # the cation keeps its pi bond
            # pyrrole-type: explicit H or 3 sigma connections (or anion)
            # contribute the lone pair; pyridine-type needs the pi
            degree = len(a.bonds) + (a.explicit_h or 0)
            if (a.explicit_h or 0) > 0 or degree >= 3 or a.charge < 0:
                return False
            return True
        if elem == "c" and a.charge != 0:
            return False                  # tropylium-style: no pi needed
        return True                       # aromatic C/B

    needy = [i for i in aro_adj if needs_pi(i)]
    needy_set = set(needy)
    matched: Dict[int, int] = {}

    def backtrack(pos: int) -> bool:
        while pos < len(needy) and needy[pos] in matched:
            pos += 1
        if pos == len(needy):
            return True
        u = needy[pos]
        for v in aro_adj[u]:
            if v in needy_set and v not in matched:
                matched[u] = v
                matched[v] = u
                if backtrack(pos + 1):
                    return True
                del matched[u], matched[v]
        return False

    if not backtrack(0):
        return False
    # write kekulized orders back: matched pairs get 2, the rest 1
    for idx, a in enumerate(atoms):
        a.bonds = [(o, (2 if matched.get(idx) == o and matched.get(o) == idx
                        else 1) if order is None else order)
                   for o, order in a.bonds]
    return True


def valence_smiles_valid(smi: str) -> bool:
    """True iff ``smi`` parses AND every atom satisfies its (charge-
    adjusted) allowed valence after kekulization — the RDKit-parse
    approximation used when RDKit itself is absent."""
    if not smi:
        return False
    atoms = _tokenize_parse(smi)
    if atoms is None:
        return False
    if not _kekulize(atoms):
        return False
    for a in atoms:
        allowed = _VALENCES.get((a.element, a.charge))
        if allowed is None:
            if (a.element in _TABLE_ELEMENTS or a.element not in _ELEMENTS
                    or a.explicit_h is None):
                # organic/halogen element in a charge state the table
                # rejects, a made-up symbol, or a non-bracket atom —
                # all rejections.  (Non-bracket atoms are organic-subset
                # only, so element is always in the table here anyway.)
                return False
            mg = _MAIN_GROUP_VALENCES.get(a.element)
            if mg is None:
                continue                  # transition metal / lanthanide /
                                          # actinide bracket atom: RDKit
                                          # default valence -1 (unchecked)
            # RDKit's effective-valence rule for main-group elements:
            # charge is subtracted from the bond+H sum, with the SIGN
            # FLIPPED for early atoms, then compared to the neutral
            # default valences — so [Na+] (0+1<=1) and [AlH4-] (4-1<=3)
            # pass while [SiH8] (8>4) and C[Na](C)C (3>1) fail.
            chg = -a.charge if a.element in _EARLY_ELEMENTS else a.charge
            ev = sum(order for _, order in a.bonds) + a.explicit_h - chg
            if ev > max(mg):
                return False
            continue
        bond_sum = sum(order for _, order in a.bonds)
        if a.explicit_h is None:          # organic subset: implicit H fill
            if not any(bond_sum <= v for v in allowed):
                return False
        else:                             # bracket atom: H count is fixed;
            # under-valence is a radical (RDKit accepts [C], [CH2]),
            # over-valence is rejected ([CH5], [NH4])
            if bond_sum + a.explicit_h > max(allowed):
                return False
    return True
