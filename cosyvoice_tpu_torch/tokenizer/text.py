"""Text tokenizers: the Qwen byte-level BPE tokenizer of CosyVoice2, the
whisper-style multilingual tokenizer of CosyVoice v1, and a byte tokenizer
for tests and smoke runs.

Port of cosyvoice_tpu/tokenizer/text.py's QwenTokenizer,
WhisperTiktokenTokenizer and ByteTokenizer.
The JAX package's QwenTokenizer wraps `transformers.AutoTokenizer`; this one
reads the HF `tokenizer.json` itself (neither `transformers` nor `tokenizers`
is needed) and gives the same ids:
  * the text is split on the added tokens (the file's `added_tokens` plus the
    CosyVoice2 specials, which take the next free ids in order), longest
    match first, before anything else;
  * the normalizer (NFC in Qwen2's file, or none) applies to the rest;
  * the pre-tokenizer in either of the forms that occur: `ByteLevel` with
    the GPT-2 regex, or Qwen2's `Split` on its regex followed by
    `ByteLevel(use_regex=False)` (any other form raises NotImplementedError).  Python's `re` has no \\p{L} / \\p{N}, so
    each regex is a scanner over `unicodedata.category` that takes its
    alternatives in order, as the regex engine does;
  * each piece is mapped to the GPT-2 byte alphabet and merged by BPE rank.
The JAX package's WhisperTiktokenTokenizer wraps `tiktoken`; this one reads
the same *.tiktoken ranks file and gives the same ids without it: the
whisper pattern is the GPT-2 regex above, and tiktoken's merge works on raw
bytes, merging the one adjacent pair whose concatenation has the lowest rank
(the leftmost of equal ones) until no concatenation has a rank, after a
whole-piece lookup.
"""
from __future__ import annotations

import base64
import json
import os
import unicodedata
from functools import lru_cache

# CosyVoice2's special tokens (the reference's tokenizer.py:241-275), added
# after the file's own: eos and pad first, then the rest in this order
COSYVOICE2_SPECIALS = (
    "<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|endofprompt|>",
    "[breath]", "<strong>", "</strong>", "[noise]", "[laughter]", "[cough]",
    "[clucking]", "[accent]", "[quick_breath]", "[hissing]", "[sigh]",
    "[vocalized-noise]", "[lipsmack]", "[mn]",
)

GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
                 r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict:
    """GPT-2's reversible map from the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_space(c: str) -> bool:
    """The regex engine's Unicode \\s (not str.isspace, which adds U+001C-1F)."""
    return c in "\t\n\x0b\x0c\r\x85" or unicodedata.category(c) in ("Zs", "Zl", "Zp")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    """[^\\s\\p{L}\\p{N}]"""
    return not (_is_space(c) or _is_letter(c) or _is_number(c))


def _run(s: str, i: int, pred) -> int:
    """The end of the run of characters from i that satisfy pred."""
    while i < len(s) and pred(s[i]):
        i += 1
    return i


def _spaces(s: str, i: int):
    """\\s+(?!\\S) then \\s+, from i (s[i] is whitespace)."""
    j = _run(s, i, _is_space)
    return j if j == len(s) or j - 1 == i else j - 1


def _gpt2_match(s: str, i: int) -> int:
    """The end of GPT2_PATTERN's match at i."""
    c = s[i]
    if c == "'":
        for w in _CONTRACTIONS:
            if s.startswith(w, i + 1):
                return i + 1 + len(w)
    k = i + 1 if c == " " and i + 1 < len(s) else i
    for pred in (_is_letter, _is_number, _is_other):   # ' ?\p{L}+', ' ?\p{N}+', ' ?[^...]+'
        if pred(s[k]):
            return _run(s, k, pred)
    return _spaces(s, i)


def _qwen2_match(s: str, i: int) -> int:
    """The end of QWEN2_PATTERN's match at i."""
    c, n = s[i], len(s)
    if c == "'":                                        # (?i:'s|'t|...)
        for w in _CONTRACTIONS:
            t = s[i + 1: i + 1 + len(w)]
            if len(t) == len(w) and all(a.casefold() == b for a, b in zip(t, w)):
                return i + 1 + len(w)
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if c not in "\r\n" and not _is_letter(c) and not _is_number(c) \
            and i + 1 < n and _is_letter(s[i + 1]):
        return _run(s, i + 1, _is_letter)
    if _is_letter(c):
        return _run(s, i, _is_letter)
    if _is_number(c):                                   # \p{N}
        return i + 1
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    k = i + 1 if c == " " and i + 1 < n and _is_other(s[i + 1]) else i
    if _is_other(s[k]):
        return _run(s, _run(s, k, _is_other), lambda x: x in "\r\n")
    # \s*[\r\n]+ : the whitespace run up to its last line break
    j = _run(s, i, _is_space)
    last = max(s.rfind("\r", i, j), s.rfind("\n", i, j))
    if last >= 0:
        return last + 1
    return _spaces(s, i)


def _split(s: str, match) -> list:
    out, i = [], 0
    while i < len(s):
        j = match(s, i)
        out.append(s[i:j])
        i = j
    return out


class QwenTokenizer:
    """tokenizer.json of a HF byte-level BPE tokenizer directory -> ids,
    with the CosyVoice2 special tokens."""

    def __init__(self, token_path: str, skip_special_tokens: bool = True):
        with open(os.path.join(token_path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if (model.get("type") != "BPE" or model.get("byte_fallback") or model.get("dropout")
                or model.get("ignore_merges")):
            raise NotImplementedError(f"{token_path}: only plain byte-level BPE is supported")
        self.vocab = dict(model["vocab"])
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        self.ranks = {m: r for r, m in enumerate(merges)}
        norm = spec.get("normalizer")
        if norm is not None and norm.get("type") != "NFC":
            raise NotImplementedError(f"{token_path}: normalizer {norm.get('type')}")
        self.nfc = norm is not None
        self.match = self._pre_tokenizer(spec.get("pre_tokenizer"))
        post = spec.get("post_processor")
        if post is not None and post.get("type") != "ByteLevel":
            raise NotImplementedError(f"{token_path}: post-processor {post.get('type')}")
        # added tokens, matched on the text before normalization: content -> (id, special)
        self.added = {}
        for t in spec.get("added_tokens", []):
            if t.get("normalized") and unicodedata.normalize("NFC", t["content"]) != t["content"]:
                raise NotImplementedError(f"{token_path}: added token {t['content']!r} "
                                          "changes under normalization")
            self.added[t["content"]] = (t["id"], t.get("special", False))
        for content in COSYVOICE2_SPECIALS:     # the next free ids, as tokenizers assigns
            if content in self.added:
                continue
            if content in self.vocab:
                tid = self.vocab[content]
            else:
                top = max((i for i, _ in self.added.values()), default=-1)
                tid = top + 1 if top >= len(self.vocab) else len(self.vocab)
            self.added[content] = (tid, True)
        self.by_length = sorted(self.added, key=len, reverse=True)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_added = {i: (t, special) for t, (i, special) in self.added.items()}
        self.byte_map = bytes_to_unicode()
        self.char_to_byte = {c: b for b, c in self.byte_map.items()}
        self.skip_special_tokens = skip_special_tokens
        self._cache: dict = {}

    @staticmethod
    def _pre_tokenizer(spec):
        """The regex scanner of the pre-tokenizer: ByteLevel with the GPT-2
        regex, or Qwen2's Split on its regex then ByteLevel without one."""
        def byte_level(p, use_regex):
            return (p["type"] == "ByteLevel" and p.get("use_regex", True) == use_regex
                    and not p.get("add_prefix_space", False))
        if spec is not None and byte_level(spec, True):
            return _gpt2_match
        if spec is not None and spec["type"] == "Sequence" and len(spec["pretokenizers"]) == 2:
            split, bl = spec["pretokenizers"]
            if (split["type"] == "Split" and split.get("behavior") == "Isolated"
                    and not split.get("invert") and byte_level(bl, False)
                    and split.get("pattern", {}).get("Regex") == QWEN2_PATTERN):
                return _qwen2_match
        raise NotImplementedError(f"pre-tokenizer {json.dumps(spec)[:200]}")

    # ---- encoding ----------------------------------------------------

    def _split_added(self, text: str) -> list:
        """[(piece, added id or None)]: the leftmost-longest matches of the
        added tokens, and the text between them."""
        out, start, i = [], 0, 0
        while i < len(text):
            hit = next((t for t in self.by_length if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if start < i:
                out.append((text[start:i], None))
            out.append((hit, self.added[hit][0]))
            i = start = i + len(hit)
        if start < len(text):
            out.append((text[start:], None))
        return out

    def _bpe(self, word: str) -> list:
        """One pre-token's ids: merge the adjacent pair of lowest rank, every
        occurrence left to right, until no pair has a rank."""
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            pair = min(zip(parts, parts[1:]), key=lambda p: self.ranks.get(p, float("inf")))
            if pair not in self.ranks:
                break
            merged, k = [], 0
            while k < len(parts):
                if k + 1 < len(parts) and (parts[k], parts[k + 1]) == pair:
                    merged.append(parts[k] + parts[k + 1])
                    k += 2
                else:
                    merged.append(parts[k])
                    k += 1
            parts = merged
        ids = [self.vocab[p] for p in parts if p in self.vocab]
        self._cache[word] = ids
        return ids

    def encode(self, text: str, **kwargs) -> list[int]:
        ids = []
        for piece, tid in self._split_added(text):
            if tid is not None:
                ids.append(tid)
                continue
            if self.nfc:
                piece = unicodedata.normalize("NFC", piece)
            for word in _split(piece, self.match):
                ids += self._bpe("".join(self.byte_map[b] for b in word.encode("utf-8")))
        return ids

    # ---- decoding ----------------------------------------------------

    def decode(self, tokens) -> str:
        out, pending = [], []

        def flush():
            data = bytes(self.char_to_byte[c] for t in pending for c in t
                         if c in self.char_to_byte)
            out.append(data.decode("utf-8", errors="replace"))
            pending.clear()
        for t in tokens:
            t = int(t)
            if t in self.id_to_added:
                content, special = self.id_to_added[t]
                if special and self.skip_special_tokens:
                    continue
                flush()
                out.append(content)
            elif t in self.id_to_token:
                pending.append(self.id_to_token[t])
        flush()
        return "".join(out)


# the v1 tokenizer's specials after its ranks (the reference's tokenizer.py)
WHISPER_SPECIALS_HEAD = ("<|endoftext|>", "<|startoftranscript|>")
WHISPER_SPECIALS_TAIL = ("<|translate|>", "<|transcribe|>", "<|startoflm|>",
                         "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>")


class WhisperTiktokenTokenizer:
    """CosyVoice v1's multilingual tokenizer: a tiktoken ranks file (one
    "base64(token) rank" a line) with the GPT-2 pattern, and the reference's
    specials after the ranks: endoftext, startoftranscript, num_languages
    language tags, the task tags, 1501 timestamps and <|endofprompt|>."""

    def __init__(self, vocab_path: str, num_languages: int = 100):
        with open(vocab_path, "rb") as f:
            self.ranks = {base64.b64decode(tok): int(rank)
                          for tok, rank in (line.split() for line in f if line.strip())}
        specials = (list(WHISPER_SPECIALS_HEAD)
                    + [f"<|lang{i}|>" for i in range(num_languages)]
                    + list(WHISPER_SPECIALS_TAIL)
                    + [f"<|{i * 0.02:.2f}|>" for i in range(1501)] + ["<|endofprompt|>"])
        n_vocab = len(self.ranks)
        self.special_tokens = {tok: n_vocab + i for i, tok in enumerate(specials)}
        self.n_vocab = n_vocab + len(specials)
        self.id_to_bytes = {r: b for b, r in self.ranks.items()}
        self.id_to_bytes.update({i: t.encode("utf-8") for t, i in self.special_tokens.items()})
        self._cache: dict = {}

    def _bpe(self, piece: bytes) -> list:
        """tiktoken's byte-pair merge of one pre-token."""
        if piece in self.ranks:
            return [self.ranks[piece]]
        if piece in self._cache:
            return self._cache[piece]
        parts = [piece[i:i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best, at = None, -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best is None or r < best):
                    best, at = r, i
            if best is None:
                break
            parts[at:at + 2] = [parts[at] + parts[at + 1]]
        ids = [self.ranks[p] for p in parts]
        self._cache[piece] = ids
        return ids

    def encode(self, text: str, **kwargs) -> list[int]:
        """Every special is allowed (the JAX package passes them all); each
        starts with "<|" and ends with "|>", so at most one matches at a
        place and the leftmost match splits the text."""
        ids, start, i = [], 0, 0
        while i < len(text):
            j = text.find("<|", i)
            if j < 0:
                break
            k = text.find("|>", j + 2)
            if k < 0:
                break
            tok = text[j:k + 2]
            if tok in self.special_tokens:
                for word in _split(text[start:j], _gpt2_match):
                    ids += self._bpe(word.encode("utf-8"))
                ids.append(self.special_tokens[tok])
                start = i = k + 2
            else:
                i = j + 1
        for word in _split(text[start:], _gpt2_match):
            ids += self._bpe(word.encode("utf-8"))
        return ids

    def decode(self, tokens) -> str:
        data = b"".join(self.id_to_bytes[int(t)] for t in tokens if int(t) < self.n_vocab)
        return data.decode("utf-8", errors="replace")


class ByteTokenizer:
    """Dependency-free tokenizer (tests / smoke runs): UTF-8 bytes + 256=eos."""

    vocab_size = 257

    def encode(self, text: str, **kwargs) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, tokens) -> str:
        return bytes(t for t in tokens if t < 256).decode("utf-8", "ignore")
