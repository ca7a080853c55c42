"""Grammar-constrained (guided) decoding: constraint compilers into token
DFAs (the port's own copy of `llm_inference_tpu/engine/guided.py`,
unchanged but for this docstring).

The host compiles a constraint (a list of allowed completions, a regex,
or a flat JSON schema) into a token-level DFA; its [S, V] allow-mask and
transition tables become device tensors in the schedulers
(engine/scheduler.py `_register_dfa`), and each row's DFA state moves on
the device from step to step in the decode chunk
(engine._decode_chunk_rows_fn), with no host round trip between steps.

Pipeline: regex/choices → character NFA (Thompson) → character DFA
(subset construction) → token DFA (walk every vocab string through the
char DFA from every state, vectorized with numpy). State 0 is the dead
state; a synthetic DONE state accepts only EOS (so a completed match
emits EOS and then self-loops on it until the scheduler retires the row).
Everything here is host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

MAX_CHAR_STATES = 4096     # subset-construction blowup guard
MAX_TOKEN_LEN = 64         # vocab strings longer than this are disallowed


# ---------------------------------------------------------------------------
# token-level DFA (the device-facing artifact)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenDFA:
    """Token-level DFA over the vocabulary.

    trans[s, t] — next state after emitting token t from state s (0=dead).
    mask[s, t]  — whether token t may be emitted from state s.
    State 0 is dead (mask all-False); `start` is the initial state."""
    trans: np.ndarray          # [S, V] int32
    mask: np.ndarray           # [S, V] bool
    start: int

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.trans.shape[1]

    def walk(self, tokens: Sequence[int]) -> int:
        """Host-side replay: state after emitting `tokens` from start
        (admission after preemption re-derives the slot's DFA state)."""
        s = self.start
        for t in tokens:
            if not self.mask[s, t]:
                return 0
            s = int(self.trans[s, t])
        return s

    def key(self) -> bytes:
        """Content key for table caching/registry dedup."""
        return (self.trans.tobytes() + self.mask.tobytes()
                + self.start.to_bytes(4, "little"))


def from_token_sequences(seqs: Sequence[Sequence[int]], vocab_size: int,
                         eos_ids: Sequence[int]) -> TokenDFA:
    """Exact-choice constraint at TOKEN level: the output must be one of
    `seqs` (then EOS). Builds the token trie directly — the tokenizer-free
    path (`guided_choice` with integer-sequence choices)."""
    if not seqs:
        raise ValueError("empty choice list")
    if not eos_ids:
        raise ValueError("guided decoding needs at least one EOS id to "
                         "terminate the match")
    # trie nodes: 0 dead, 1 root, 2 done (EOS self-loop), 3+ interior
    nxt: List[Dict[int, int]] = [{}, {}, {}]
    ROOT, DONE = 1, 2
    accept = set()          # nodes where a choice ends (EOS → DONE)
    for seq in seqs:
        seq = list(seq)
        if not seq:
            raise ValueError("empty choice")
        if any(not 0 <= t < vocab_size for t in seq):
            raise ValueError(f"choice token out of range: {seq}")
        s = ROOT
        for t in seq:
            if t in nxt[s]:
                s = nxt[s][t]
            else:
                nxt.append({})
                if len(nxt) > 32000:
                    # device transition tables are int16 (scheduler), and
                    # a trie this size signals a misuse of guided_choice
                    raise ValueError("choice trie too large (>32000 "
                                     "states) — use fewer/shorter choices")
                nxt[s][t] = len(nxt) - 1
                s = len(nxt) - 1
        accept.add(s)
    S = len(nxt)
    trans = np.zeros((S, vocab_size), np.int32)
    mask = np.zeros((S, vocab_size), bool)
    for s, edges in enumerate(nxt):
        for t, ns in edges.items():
            trans[s, t] = ns
            mask[s, t] = True
    for e in eos_ids:
        if 0 <= e < vocab_size:
            for s in accept:
                mask[s, e] = True
                trans[s, e] = DONE
            mask[DONE, e] = True
            trans[DONE, e] = DONE
    return TokenDFA(trans=trans, mask=mask, start=ROOT)


# ---------------------------------------------------------------------------
# regex subset → char NFA (Thompson construction)
# ---------------------------------------------------------------------------
# Supported: literals, escapes (\d \w \s \n \t \r \\ \. etc.), '.',
# [...] classes (ranges, negation), concatenation, '|', groups '(...)',
# quantifiers * + ? {m} {m,} {m,n}. Anchored at both ends (the whole
# output must match), like structured-output engines.

_DIGITS = frozenset("0123456789")
_WORD = frozenset("abcdefghijklmnopqrstuvwxyz"
                  "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")


@dataclasses.dataclass(frozen=True)
class _CharSet:
    """Edge label: a char set, possibly negated ("any char except")."""
    chars: FrozenSet[str]
    negated: bool = False

    def accepts(self, c: str) -> bool:
        return (c not in self.chars) if self.negated else (c in self.chars)


class _Frag:
    """NFA fragment: start state + dangling out-state (single exit)."""
    __slots__ = ("start", "end")

    def __init__(self, start: int, end: int):
        self.start, self.end = start, end


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []            # state -> eps targets
        self.edges: List[List[Tuple[_CharSet, int]]] = []

    def new_state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def frag_char(self, cs: _CharSet) -> _Frag:
        a, b = self.new_state(), self.new_state()
        self.edges[a].append((cs, b))
        return _Frag(a, b)

    def frag_empty(self) -> _Frag:
        a = self.new_state()
        return _Frag(a, a)

    def concat(self, f1: _Frag, f2: _Frag) -> _Frag:
        self.eps[f1.end].append(f2.start)
        return _Frag(f1.start, f2.end)

    def alt(self, frags: List[_Frag]) -> _Frag:
        a, b = self.new_state(), self.new_state()
        for f in frags:
            self.eps[a].append(f.start)
            self.eps[f.end].append(b)
        return _Frag(a, b)

    def star(self, f: _Frag) -> _Frag:
        a, b = self.new_state(), self.new_state()
        self.eps[a] += [f.start, b]
        self.eps[f.end] += [f.start, b]
        return _Frag(a, b)

    def plus(self, f: _Frag) -> _Frag:
        a, b = self.new_state(), self.new_state()
        self.eps[a].append(f.start)
        self.eps[f.end] += [f.start, b]
        return _Frag(a, b)

    def opt(self, f: _Frag) -> _Frag:
        a, b = self.new_state(), self.new_state()
        self.eps[a] += [f.start, b]
        self.eps[f.end].append(b)
        return _Frag(a, b)


class _RegexParser:
    """Recursive-descent parser building Thompson NFA fragments."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.nfa = _NFA()

    def parse(self) -> Tuple[_NFA, int, int]:
        frag = self._alternation()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at "
                             f"{self.i} in regex {self.p!r}")
        return self.nfa, frag.start, frag.end

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _alternation(self) -> _Frag:
        frags = [self._concat()]
        while self._peek() == "|":
            self.i += 1
            frags.append(self._concat())
        return frags[0] if len(frags) == 1 else self.nfa.alt(frags)

    def _concat(self) -> _Frag:
        frags = []
        while self._peek() is not None and self._peek() not in "|)":
            frags.append(self._repeat())
        if not frags:
            return self.nfa.frag_empty()
        out = frags[0]
        for f in frags[1:]:
            out = self.nfa.concat(out, f)
        return out

    def _repeat(self) -> _Frag:
        f = self._atom()
        c = self._peek()
        if c == "*":
            self.i += 1
            return self.nfa.star(f)
        if c == "+":
            self.i += 1
            return self.nfa.plus(f)
        if c == "?":
            self.i += 1
            return self.nfa.opt(f)
        if c == "{":
            j = self.p.index("}", self.i)
            body = self.p[self.i + 1:j]
            self.i = j + 1
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s or 0)
                hi = int(hi_s) if hi_s else None
            else:
                lo = hi = int(body)
            # expand {m,n} by duplicating the sub-NFA (re-parse the atom
            # source): find the atom's source span
            return self._expand_repeat(f, lo, hi)
        return f

    def _expand_repeat(self, first: _Frag, lo: int,
                       hi: Optional[int]) -> _Frag:
        """{m,n} via duplication. `first` is one already-built copy; the
        atom's source span was just consumed — re-parse it for copies."""
        # re-find the atom source: scan backwards is fragile; instead we
        # remember the span in _atom (set as self._last_atom_span)
        a0, a1 = self._last_atom_span
        src = self.p[a0:a1]

        def copy() -> _Frag:
            sub = _RegexParser(src)
            sub.nfa = self.nfa          # build into the same NFA
            f = sub._alternation()
            if sub.i != len(src):
                raise ValueError(f"bad repeat atom {src!r}")
            return f

        if hi is not None and hi < lo:
            raise ValueError(f"bad repeat bounds {{{lo},{hi}}}")
        if lo == 0 and hi is None:          # {0,} == *
            return self.nfa.star(first)
        if hi == 0:                          # {0} / {0,0}: exactly empty
            # (`first` stays orphaned in the NFA — unreachable, harmless)
            return self.nfa.frag_empty()
        parts: List[_Frag] = []
        if lo > 0:
            parts.append(first)
            for _ in range(lo - 1):
                parts.append(copy())
        if hi is None:                       # {m,} -> m copies + star
            parts.append(self.nfa.star(copy()))
        else:
            opt_count = hi - lo
            if lo == 0:
                parts.append(self.nfa.opt(first))
                opt_count -= 1
            for _ in range(opt_count):
                parts.append(self.nfa.opt(copy()))
        out = parts[0]
        for f in parts[1:]:
            out = self.nfa.concat(out, f)
        return out

    def _atom(self) -> _Frag:
        a0 = self.i
        c = self._peek()
        if c is None:
            raise ValueError("unexpected end of regex")
        if c == "(":
            self.i += 1
            f = self._alternation()
            if self._peek() != ")":
                raise ValueError("unbalanced '(' in regex")
            self.i += 1
            self._last_atom_span = (a0, self.i)
            return f
        if c == "[":
            cs = self._char_class()
            self._last_atom_span = (a0, self.i)
            return self.nfa.frag_char(cs)
        if c == ".":
            self.i += 1
            self._last_atom_span = (a0, self.i)
            return self.nfa.frag_char(_CharSet(frozenset("\n"),
                                               negated=True))
        if c == "\\":
            cs = self._escape()
            self._last_atom_span = (a0, self.i)
            return self.nfa.frag_char(cs)
        if c in "*+?{":
            raise ValueError(f"nothing to repeat at {self.i} in "
                             f"{self.p!r}")
        self.i += 1
        self._last_atom_span = (a0, self.i)
        return self.nfa.frag_char(_CharSet(frozenset(c)))

    def _escape(self) -> _CharSet:
        self.i += 1                          # consume '\'
        c = self._peek()
        if c is None:
            raise ValueError("trailing backslash")
        self.i += 1
        if c == "d":
            return _CharSet(_DIGITS)
        if c == "D":
            return _CharSet(_DIGITS, negated=True)
        if c == "w":
            return _CharSet(_WORD)
        if c == "W":
            return _CharSet(_WORD, negated=True)
        if c == "s":
            return _CharSet(_SPACE)
        if c == "S":
            return _CharSet(_SPACE, negated=True)
        if c == "n":
            return _CharSet(frozenset("\n"))
        if c == "t":
            return _CharSet(frozenset("\t"))
        if c == "r":
            return _CharSet(frozenset("\r"))
        return _CharSet(frozenset(c))        # \. \\ \[ \{ ...

    def _char_class(self) -> _CharSet:
        assert self.p[self.i] == "["
        self.i += 1
        negated = self._peek() == "^"
        if negated:
            self.i += 1
        chars = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise ValueError("unbalanced '[' in regex")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if c == "\\":
                sub = self._escape()
                if sub.negated:
                    raise ValueError("negated escape inside class")
                chars |= sub.chars
                continue
            self.i += 1
            if (self._peek() == "-" and self.i + 1 < len(self.p)
                    and self.p[self.i + 1] != "]"):
                self.i += 1
                hi = self.p[self.i]
                self.i += 1
                for o in range(ord(c), ord(hi) + 1):
                    chars.add(chr(o))
            else:
                chars.add(c)
        return _CharSet(frozenset(chars), negated=negated)


# ---------------------------------------------------------------------------
# char NFA → char DFA (subset construction with default "other" moves)
# ---------------------------------------------------------------------------

class CharDFA:
    """Deterministic char automaton.

    `trans[s]` maps explicit chars; `default[s]` is the move on any char
    not in trans[s] (0 = dead). State 0 is dead, `start` initial."""

    def __init__(self, trans: List[Dict[str, int]], default: List[int],
                 accept: FrozenSet[int], start: int):
        self.trans = trans
        self.default = default
        self.accept = accept
        self.start = start

    def step(self, s: int, c: str) -> int:
        return self.trans[s].get(c, self.default[s])


def _nfa_to_dfa(nfa: _NFA, start: int, end: int) -> CharDFA:
    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        stack, out = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = closure(frozenset([start]))
    ids: Dict[FrozenSet[int], int] = {frozenset(): 0, start_set: 1}
    work = [start_set]
    trans: List[Dict[str, int]] = [{}, {}]
    default: List[int] = [0, 0]
    accept = set()
    if end in start_set:
        accept.add(1)
    while work:
        T = work.pop()
        tid = ids[T]
        # explicit symbols relevant to this state set
        symbols = set()
        for s in T:
            for cs, _ in nfa.edges[s]:
                symbols |= cs.chars
        # move on "any other char": targets of negated edges only
        other = set()
        for s in T:
            for cs, t in nfa.edges[s]:
                if cs.negated:
                    other.add(t)
        other_set = closure(frozenset(other)) if other else frozenset()

        def register(U: FrozenSet[int]) -> int:
            if U not in ids:
                ids[U] = len(trans)
                trans.append({})
                default.append(0)
                if len(trans) > MAX_CHAR_STATES:
                    raise ValueError("regex too complex (DFA state "
                                     "blowup)")
                if end in U:
                    accept.add(ids[U])
                work.append(U)
            return ids[U]

        if other_set:
            default[tid] = register(other_set)
        for c in symbols:
            targets = set()
            for s in T:
                for cs, t in nfa.edges[s]:
                    if cs.accepts(c):
                        targets.add(t)
            U = closure(frozenset(targets)) if targets else frozenset()
            uid = register(U) if U else 0
            if uid != default[tid]:
                trans[tid][c] = uid
            elif c in trans[tid]:
                del trans[tid][c]
            # equal to default: leave implicit
            if uid == default[tid]:
                continue
    return CharDFA(trans, default, frozenset(accept), start=1)


def char_dfa_for_regex(pattern: str) -> CharDFA:
    nfa, start, end = _RegexParser(pattern).parse()
    return _nfa_to_dfa(nfa, start, end)


def char_dfa_for_choices(choices: Sequence[str]) -> CharDFA:
    """Exact string choices → char trie DFA (no regex machinery)."""
    if not choices:
        raise ValueError("empty choice list")
    trans: List[Dict[str, int]] = [{}, {}]
    default = [0, 0]
    accept = set()
    for s in choices:
        if not s:
            raise ValueError("empty choice string")
        cur = 1
        for c in s:
            if c in trans[cur]:
                cur = trans[cur][c]
            else:
                trans.append({})
                default.append(0)
                trans[cur][c] = len(trans) - 1
                cur = len(trans) - 1
        accept.add(cur)
    return CharDFA(trans, default, frozenset(accept), start=1)


# ---------------------------------------------------------------------------
# char DFA → token DFA (vectorized vocab walk)
# ---------------------------------------------------------------------------

def token_dfa_from_char_dfa(dfa: CharDFA, vocab_strings: Sequence[str],
                            eos_ids: Sequence[int]) -> TokenDFA:
    """Lift a char DFA to the vocabulary: token t is allowed from char
    state s iff walking t's decoded string from s never dies; the result
    state is the walk's end. Tokens that decode to "" (specials) are
    disallowed — they would make no progress. A DONE state (only EOS,
    self-loop) terminates matches from accepting states."""
    if not eos_ids:
        raise ValueError("guided decoding needs at least one EOS id")
    SC = len(dfa.trans)
    V = len(vocab_strings)
    # alphabet: explicit chars anywhere in the DFA
    alphabet = sorted({c for tr in dfa.trans for c in tr})
    col = {c: i for i, c in enumerate(alphabet)}
    A = len(alphabet)
    # dense char-step table: [SC, A+1]; last column = default ("other")
    D = np.zeros((SC, A + 1), np.int32)
    for s in range(SC):
        D[s, :] = dfa.default[s]
        for c, t in dfa.trans[s].items():
            D[s, col[c]] = t
    states = np.arange(SC, dtype=np.int32)

    # walk every token from EVERY char state at once, caching by string
    end_cache: Dict[str, np.ndarray] = {}

    def walk(u: str) -> np.ndarray:
        out = end_cache.get(u)
        if out is not None:
            return out
        cur = states
        for c in u:
            cur = D[cur, col.get(c, A)]
        end_cache[u] = cur
        return cur

    DONE = SC                     # appended state
    S = SC + 1
    trans = np.zeros((S, V), np.int32)
    mask = np.zeros((S, V), bool)
    for t, u in enumerate(vocab_strings):
        if not u or len(u) > MAX_TOKEN_LEN:
            continue
        ends = walk(u)            # [SC]
        ok = ends != 0
        ok[0] = False             # dead stays dead
        mask[:SC, t] = ok
        trans[:SC, t] = np.where(ok, ends, 0)
    for e in eos_ids:
        if 0 <= e < V:
            for s in dfa.accept:
                mask[s, e] = True
                trans[s, e] = DONE
            mask[DONE, e] = True
            trans[DONE, e] = DONE
    return TokenDFA(trans=trans, mask=mask, start=dfa.start)


def vocab_strings(tokenizer, vocab_size: int) -> List[str]:
    """Decoded piece per vocab id (cached on the tokenizer object)."""
    cached = getattr(tokenizer, "_guided_vocab_strings", None)
    if cached is not None and len(cached) == vocab_size:
        return cached
    out = []
    for t in range(vocab_size):
        try:
            out.append(tokenizer.decode_token(t))
        except Exception:
            out.append("")
    try:
        tokenizer._guided_vocab_strings = out
    except Exception:
        pass
    return out


def dfa_for_regex(pattern: str, tokenizer, vocab_size: int,
                  eos_ids: Sequence[int]) -> TokenDFA:
    return token_dfa_from_char_dfa(char_dfa_for_regex(pattern),
                                   vocab_strings(tokenizer, vocab_size),
                                   eos_ids)


def dfa_for_choices(choices: Sequence[str], tokenizer, vocab_size: int,
                    eos_ids: Sequence[int]) -> TokenDFA:
    return token_dfa_from_char_dfa(char_dfa_for_choices(choices),
                                   vocab_strings(tokenizer, vocab_size),
                                   eos_ids)


# ---------------------------------------------------------------------------
# flat JSON schema → regex
# ---------------------------------------------------------------------------

_STR_RE = r'"([^"\\]|\\["\\nrt])*"'
_INT_RE = r"-?(0|[1-9]\d*)"
_NUM_RE = r"-?(0|[1-9]\d*)(\.\d+)?([eE][-+]?\d+)?"
_BOOL_RE = r"(true|false)"
_WS = r"\s?"


def _value_regex(spec: dict) -> str:
    if "enum" in spec:
        import json as _json
        alts = []
        for v in spec["enum"]:
            alts.append(_escape_literal(_json.dumps(v)))
        return "(" + "|".join(alts) + ")"
    t = spec.get("type", "string")
    if t == "string":
        return _STR_RE
    if t == "integer":
        return _INT_RE
    if t == "number":
        return _NUM_RE
    if t == "boolean":
        return _BOOL_RE
    if t == "null":
        return "null"
    if t == "array":
        item = _value_regex(spec.get("items", {"type": "string"}))
        mn = spec.get("minItems", 0)
        mx = spec.get("maxItems")
        tail = f"({_WS},{_WS}{item})"
        if mx is None:
            rep = f"{tail}*" if mn <= 1 else f"{tail}{{{mn - 1},}}"
        else:
            rep = f"{tail}{{{max(mn - 1, 0)},{mx - 1}}}"
        body = f"{item}{rep}" if mx is None or mx >= 1 else ""
        if mn == 0:
            return rf"\[{_WS}({body}){{0,1}}{_WS}\]"
        return rf"\[{_WS}{body}{_WS}\]"
    if t == "object":
        # a FIXED-KEY nested object schema has a finite serialization
        # language — still regular, recurse. Only unbounded recursion
        # ($ref cycles / free-form objects) would need a pushdown.
        if "properties" not in spec:
            raise ValueError(
                "free-form 'object' values are unbounded (pushdown "
                "territory) — give the nested object 'properties', or "
                "use json_value_regex for depth-bounded free-form JSON")
        return regex_for_json_schema(spec)
    raise ValueError(f"unsupported JSON schema type {t!r}")


def json_value_regex(max_depth: int = 3) -> str:
    """Depth-bounded free-form JSON value (OpenAI response_format
    json_object): scalars at every depth; objects/arrays nest up to
    `max_depth` levels. The depth bound keeps the language regular."""
    scalar = f"({_STR_RE}|{_NUM_RE}|{_BOOL_RE}|null)"
    out = scalar
    for _ in range(max_depth):
        kv = f"{_STR_RE}{_WS}:{_WS}{out}"
        obj = rf"\{{{_WS}({kv}({_WS},{_WS}{kv})*)?{_WS}\}}"
        arr = rf"\[{_WS}({out}({_WS},{_WS}{out})*)?{_WS}\]"
        out = f"({scalar}|{obj}|{arr})"
    # top level must be an object or array (json_object semantics)
    kv = f"{_STR_RE}{_WS}:{_WS}{out}"
    return rf"\{{{_WS}({kv}({_WS},{_WS}{kv})*)?{_WS}\}}"


def _escape_literal(s: str) -> str:
    out = []
    for c in s:
        if c in r"\.[]{}()*+?|^$/":
            out.append("\\" + c)
        else:
            out.append(c)
    return "".join(out)


def regex_for_json_schema(schema: dict) -> str:
    """JSON-object schema → anchored regex for the serialized object.
    Properties emit in declaration order; `required` (default: all) may
    drop optional TRAILING properties; fixed-key nested objects recurse
    (finite language — regular)."""
    if schema.get("type", "object") != "object":
        return _value_regex(schema)
    props = schema.get("properties", {})
    if not props:
        return rf"\{{{_WS}\}}"
    required = set(schema.get("required", list(props)))
    names = list(props)
    pieces = []
    for i, name in enumerate(names):
        key = _escape_literal(f'"{name}"') + f"{_WS}:{_WS}"
        if name not in required and any(n in required
                                        for n in names[i + 1:]):
            raise ValueError(
                f"optional property {name!r} precedes a required one "
                f"— only trailing optionals are expressible")
        pieces.append((key + _value_regex(props[name]), name in required))
    n_req = sum(1 for _, r in pieces if r)
    comma = f"{_WS},{_WS}"
    req_body = comma.join(p for p, r in pieces if r)
    opts = [p for p, r in pieces if not r]
    if n_req > 0:
        # each optional carries its own leading comma — always valid
        # because at least one required property precedes it
        body = req_body + "".join(f"({comma}{p})?" for p in opts)
    elif opts:
        # all-optional: the FIRST present property has no comma, the rest
        # each carry one — alternation over which optional appears first
        alts = []
        for j in range(len(opts)):
            tail = "".join(f"({comma}{p})?" for p in opts[j + 1:])
            alts.append(opts[j] + tail)
        body = "((" + ")|(".join(alts) + "))?"
    else:
        body = ""
    return rf"\{{{_WS}" + body + rf"{_WS}\}}"


def dfa_for_json_schema(schema: dict, tokenizer, vocab_size: int,
                        eos_ids: Sequence[int]) -> TokenDFA:
    return dfa_for_regex(regex_for_json_schema(schema), tokenizer,
                         vocab_size, eos_ids)


_COMPILE_CACHE: Dict = {}
_COMPILE_CACHE_MAX = 64


def compile_constraint(vocab_size: int, eos_ids: Sequence[int],
                       tokenizer=None,
                       choice: Optional[Sequence] = None,
                       regex: Optional[str] = None,
                       json_schema: Optional[dict] = None) -> TokenDFA:
    """One-stop constraint compiler for the serving layer. Exactly one of
    choice/regex/json_schema must be given. `choice` may be strings (needs
    a tokenizer) or token-id sequences (tokenizer-free).

    Results are memoized (the vocab walk is the expensive part — the
    serving path compiles each distinct constraint once, not per
    request); unsatisfiable constraints (no token can start a match)
    are rejected here rather than emitting garbage at decode time."""
    given = [x is not None for x in (choice, regex, json_schema)]
    if sum(given) != 1:
        raise ValueError("exactly one of guided_choice / guided_regex / "
                         "guided_json must be set")
    import json as _json
    key = (vocab_size, tuple(eos_ids), id(tokenizer),
           _json.dumps(choice, sort_keys=True) if choice is not None
           else None,
           regex,
           _json.dumps(json_schema, sort_keys=True)
           if json_schema is not None else None)
    hit = _COMPILE_CACHE.get(key)
    if hit is not None:
        return hit
    if choice is not None:
        if len(choice) == 0:
            raise ValueError("empty choice list")
        if all(isinstance(c, str) for c in choice):
            if tokenizer is None:
                raise ValueError("string guided_choice needs a tokenizer")
            dfa = dfa_for_choices(choice, tokenizer, vocab_size, eos_ids)
        else:
            dfa = from_token_sequences(choice, vocab_size, eos_ids)
    else:
        if tokenizer is None:
            raise ValueError("guided_regex / guided_json need a tokenizer")
        if regex is not None:
            dfa = dfa_for_regex(regex, tokenizer, vocab_size, eos_ids)
        else:
            dfa = dfa_for_json_schema(json_schema, tokenizer, vocab_size,
                                      eos_ids)
    if not dfa.mask[dfa.start].any():
        raise ValueError(
            "constraint is unsatisfiable with this vocabulary (no token "
            "can begin a match)")
    if len(_COMPILE_CACHE) >= _COMPILE_CACHE_MAX:
        _COMPILE_CACHE.pop(next(iter(_COMPILE_CACHE)))
    _COMPILE_CACHE[key] = dfa
    return dfa
