"""Tokenizers: SentencePiece-style BPE over the reference's binary
vocabulary format, and a wrapper over the `tokenizers` package
(counterpart of `llm_inference_tpu/engine/tokenizer.py`).

The binary format:
  int32 version
  if version >= 1: int32 n_kv, then n_kv x (length-prefixed key, value)
  int32 vocab_len
  per token: int32 n_bytes, n_bytes x int32 (one byte each), int32
  token_id, float32 score

Encoding is score-ordered SentencePiece BPE: start from the single
characters of the text with a leading space and every space as U+2581,
repeatedly merge the adjacent pair whose concatenation is a vocabulary
piece of the highest score (leftmost on ties), and spell what stays
unmerged in <0xNN> byte pieces (byte fallback). Every space is kept,
as SentencePiece keeps them. The JAX package's native C++ encoder is not
ported: `load_tokenizer` reads a .bin vocabulary with the Python one,
which gives the same ids.
"""

from __future__ import annotations

import heapq
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

_SP_SPACE = "▁".encode("utf-8")   # ▁ = bytes (226, 150, 129)


class BPETokenizer:
    """Score-based BPE over byte-string vocab (llama/sentencepiece style)."""

    def __init__(self, vocab: Dict[bytes, Tuple[int, float]],
                 kv: Optional[Dict[str, str]] = None,
                 bos_id: int = 1, eos_id: int = 2, unk_id: int = 0):
        # id_to_token keeps raw bytes (exact decode); the merge tables are
        # keyed by str because SentencePiece BPE merges unicode characters,
        # not bytes (a byte-level merge could never reach multi-byte pieces
        # like "▁Hello" without intermediate invalid-UTF-8 vocab entries).
        self.token_to_id: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        self.id_to_token: Dict[int, bytes] = {}
        for tok, (tid, score) in vocab.items():
            tok_s = tok.decode("utf-8", errors="replace")
            self.token_to_id[tok_s] = tid
            self.scores[tok_s] = score
            self.id_to_token[tid] = tok
        self.kv = kv or {}
        self.bos_id = int(self.kv.get("bos_token_id", bos_id))
        self.eos_id = int(self.kv.get("eos_token_id", eos_id))
        self.unk_id = unk_id
        self._byte_tokens = {
            i: self.token_to_id.get("<0x%02X>" % i) for i in range(256)
        }

    # -- construction ------------------------------------------------------

    @classmethod
    def from_binary(cls, path: str) -> "BPETokenizer":
        """Read the reference's binary vocab file (format above)."""
        with open(path, "rb") as f:
            data = f.read()
        off = 0

        def ri():
            nonlocal off
            v = struct.unpack_from("<i", data, off)[0]
            off += 4
            return v

        def rf():
            nonlocal off
            v = struct.unpack_from("<f", data, off)[0]
            off += 4
            return v

        def rs():
            nonlocal off
            n = ri()
            s = data[off:off + n]
            off += n
            return s.decode("utf-8", errors="replace")

        version = ri()
        kv = {}
        if version >= 1:
            for _ in range(ri()):
                k = rs()
                v = rs()
                kv[k] = v
        vocab: Dict[bytes, Tuple[int, float]] = {}
        n_vocab = ri()
        for _ in range(n_vocab):
            n_chars = ri()
            toks = bytes(ri() & 0xFF for _ in range(n_chars))
            tid = ri()
            score = rf()
            vocab[toks] = (tid, score)
        return cls(vocab, kv)

    def save_binary(self, path: str, version: int = 1) -> None:
        """Write the same binary format (round-trip / export for the
        reference engine)."""
        with open(path, "wb") as f:
            f.write(struct.pack("<i", version))
            f.write(struct.pack("<i", len(self.kv)))
            for k, v in self.kv.items():
                kb, vb = k.encode(), str(v).encode()
                f.write(struct.pack("<i", len(kb)) + kb)
                f.write(struct.pack("<i", len(vb)) + vb)
            # count must match the entries actually written (id_to_token);
            # token_to_id can be smaller if byte-distinct pieces collide
            # under the errors="replace" string keying
            f.write(struct.pack("<i", len(self.id_to_token)))
            for tid, tok in self.id_to_token.items():
                tok_s = tok.decode("utf-8", errors="replace")
                f.write(struct.pack("<i", len(tok)))
                for b in tok:
                    f.write(struct.pack("<i", b))
                f.write(struct.pack("<i", tid))
                f.write(struct.pack("<f", self.scores.get(tok_s, 0.0)))

    @property
    def vocab_size(self) -> int:
        return max(self.id_to_token) + 1 if self.id_to_token else 0

    # -- encode ------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        # SentencePiece: prepend a space, every space → ▁
        return "▁" + text.replace(" ", "▁")

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        s = self._normalize(text)
        n = len(s)
        if n == 0:
            return [self.bos_id] if add_bos else []

        # doubly-linked list of symbols over the byte string
        start = list(range(n))            # symbol i covers s[start:end)
        end = [i + 1 for i in range(n)]
        prev = [i - 1 for i in range(n)]
        nxt = [i + 1 for i in range(n)]
        nxt[-1] = -1
        alive = [True] * n

        def piece(i):
            return s[start[i]:end[i]]

        heap: List[Tuple[float, int, int]] = []

        def push(l):
            r = nxt[l]
            if l < 0 or r < 0:
                return
            cand = s[start[l]:end[r]]
            sc = self.scores.get(cand)
            if sc is not None:
                # max-score first; leftmost on ties
                heapq.heappush(heap, (-sc, l, end[r] - start[l]))

        for i in range(n - 1):
            push(i)

        while heap:
            negsc, l, size = heapq.heappop(heap)
            r = nxt[l] if l >= 0 else -1
            if (l < 0 or r < 0 or not alive[l] or not alive[r]
                    or end[r] - start[l] != size):
                continue
            # merge r into l
            end[l] = end[r]
            alive[r] = False
            nxt[l] = nxt[r]
            if nxt[r] >= 0:
                prev[nxt[r]] = l
            push(l)
            if prev[l] >= 0:
                push(prev[l])

        ids: List[int] = [self.bos_id] if add_bos else []
        i = 0
        while i != -1:
            if alive[i]:
                p = piece(i)
                tid = self.token_to_id.get(p)
                if tid is not None:
                    ids.append(tid)
                else:
                    for b in p.encode("utf-8"):      # byte fallback
                        bt = self._byte_tokens[b]
                        ids.append(bt if bt is not None else self.unk_id)
            i = nxt[i]
        return ids

    # -- decode ------------------------------------------------------------

    def decode(self, ids: Sequence[int]) -> str:
        out = bytearray()
        for tid in ids:
            tok = self.id_to_token.get(int(tid))
            if tok is None:
                continue
            if len(tok) == 6 and tok[:3] == b"<0x" and tok[-1:] == b">":
                out.append(int(tok[3:5], 16))
            elif tok in (b"<s>", b"</s>", b"<unk>"):
                continue
            else:
                out += tok
        text = out.decode("utf-8", errors="replace")
        return _strip_leading_space(text.replace("▁", " "))

    def decode_token(self, tid: int) -> str:
        """Streaming single-token decode (may return partial utf-8 as ''). """
        tok = self.id_to_token.get(int(tid))
        if tok is None or tok in (b"<s>", b"</s>", b"<unk>"):
            return ""
        if len(tok) == 6 and tok[:3] == b"<0x" and tok[-1:] == b">":
            return bytes([int(tok[3:5], 16)]).decode("utf-8", errors="ignore")
        return tok.decode("utf-8", errors="ignore").replace("▁", " ")


def _strip_leading_space(text: str) -> str:
    return text[1:] if text.startswith(" ") else text


class HFTokenizer:
    """Wrapper over the `tokenizers` library (tokenizer.json checkpoints).
    The package is imported here, not with the module: a machine without
    it can still use the binary vocabulary."""

    def __init__(self, path: str):
        try:
            from tokenizers import Tokenizer as _T
        except ImportError as e:
            raise ImportError(
                f"{path}: a tokenizer.json needs the `tokenizers` package, "
                "which is not installed; use the binary vocabulary "
                "(BPETokenizer.save_binary / a .bin path) instead") from e
        self._t = _T.from_file(path)

        def _tid(tok, default):
            t = self._t.token_to_id(tok)
            return default if t is None else t   # id 0 is a valid id
        self.bos_id = _tid("<s>", 1)
        self.eos_id = _tid("</s>", 2)

    @property
    def vocab_size(self) -> int:
        return self._t.get_vocab_size()

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._t.encode(text).ids
        return ([self.bos_id] + ids) if add_bos and (
            not ids or ids[0] != self.bos_id) else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._t.decode(list(int(i) for i in ids))

    def decode_token(self, tid: int) -> str:
        return self._t.decode([int(tid)])


def load_tokenizer(path: str):
    """A .bin path → BPETokenizer; a tokenizer.json (or a directory that
    holds one) → HFTokenizer; a directory with a *tokenizer*.bin → that."""
    if os.path.isdir(path):
        tj = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj):
            return HFTokenizer(tj)
        for fn in sorted(os.listdir(path)):
            if fn.endswith(".bin") and "tokenizer" in fn:
                return BPETokenizer.from_binary(os.path.join(path, fn))
        raise FileNotFoundError(f"no tokenizer found under {path}")
    if path.endswith(".json"):
        return HFTokenizer(path)
    return BPETokenizer.from_binary(path)
