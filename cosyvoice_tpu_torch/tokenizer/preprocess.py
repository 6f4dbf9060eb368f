"""Corpus-prep text utilities (Mandarin/English code-switching).

The port's own copy of cosyvoice_tpu/tokenizer/preprocess.py (pure Python,
so the two agree line for line; the port imports nothing of the JAX
package).

Behavioral spec: reference `cosyvoice/tokenizer/preprocess.py` — SEAME-style
normalization for BPE-tokenizer training corpora: punctuation stripping,
full-width -> ASCII folding, control-char removal, noise-tag collapsing,
Mandarin/English separation, and the kaldi-text writers that produce the
Mandarin char vocab + English BPE train text.  Pure text; no tensors.
"""
from __future__ import annotations

import collections
import re
from typing import Iterable, Iterator

# punctuation folded to spaces (preprocess.py:31-32)
_REMOVE_PUNC = "()[]{}.,?·@，。、「」＃\"~-—#%_`｀×*（）［］&【】～ｌ\\"
_PUNC_TABLE = str.maketrans(_REMOVE_PUNC, " " * len(_REMOVE_PUNC))

# full-width letters (+ é) -> ASCII (preprocess.py:34-37)
_FW_SRC = ("ａｂｃｄｅｆｇｈｉｊｋｌｍｎｏｐｑｒｓｔｕｖｗｘｙｚ"
           "ＡＢＣＤＥＦＧＨＩＪＫＬＭＮＯＰＱＲＳＴＵＶＷＸＹＺé")
_FW_DST = "abcdefghijklmnopqrstuvwxyz" * 2 + "e"
_FW_TABLE = str.maketrans(_FW_SRC, _FW_DST)

_CONTROL_RE = re.compile("[%s]" % re.escape(
    "".join(map(chr, list(range(0x00, 0x20)) + list(range(0x7F, 0xA0))))))

_NOISE_WORDS = {"ppl", "ppc", "ppb", "ppo", "<v-noise>"}


def remove_control_chars(text: str) -> str:
    return _CONTROL_RE.sub("", text)


def remove_redundant_whitespaces(text: str) -> str:
    return re.sub(" +", " ", text).strip()


def is_english(c: str) -> bool:
    return "a" <= c.lower() <= "z"


def is_mandarin(c: str) -> bool:
    """Everything that is not English/digit/separator (preprocess.py:59-66)."""
    return not is_english(c) and not c.isdigit() and c not in " <>',.:"


def extract_mandarin_only(text: str) -> str:
    return "".join(c for c in text if is_mandarin(c))


def extract_non_mandarin(text: str) -> str:
    return " ".join(w for w in text.split(" ")
                    if not any(is_mandarin(c) for c in w))


def remove_space_between_mandarin(text: str) -> str:
    """Join space-separated units, keeping a space only at English borders."""
    if len(text) <= 1:
        return text
    parts = text.strip().split()
    out = parts[0]
    for i in range(1, len(parts)):
        if is_english(parts[i - 1][-1]):
            out += " "
        if is_english(parts[i][0]):
            out += " "
        out += parts[i]
    return out


def insert_space_between_mandarin(text: str) -> str:
    """Surround each Mandarin char with spaces (preprocess.py:93-109)."""
    if len(text) <= 1:
        return text
    out = text[0]
    for i in range(1, len(text)):
        if is_mandarin(text[i - 1]) and not is_mandarin(text[i]):
            out += " "
        if is_mandarin(text[i]):
            out += " "
        out += text[i]
        if is_mandarin(text[i]):
            out += " "
    return out


def remove_repeated_noise(text: str, pattern: str = "<noise>") -> str:
    """Collapse runs of the noise tag to one (preprocess.py:111-127)."""
    if len(re.findall(pattern, text)) <= 1:
        return text
    parts = text.split()
    out = [parts[0]]
    for i in range(1, len(parts)):
        if parts[i] == pattern and parts[i - 1] == pattern:
            continue
        out.append(parts[i])
    return " ".join(out)


def normalize_text(text: str) -> str:
    """Full corpus-text normalization chain (preprocess.py:129-166)."""
    t = re.sub(r"\(((pp)(\w)+)\)", "<noise>", text.lower())
    t = re.sub(r"\<((pp)(\w)+)\>", "<noise>", t)
    t = t.translate(_PUNC_TABLE)
    t = remove_control_chars(t)
    t = " ".join("<noise>" if w in _NOISE_WORDS else w for w in t.split())
    t = t.translate(_FW_TABLE)
    t = t.replace("<unl>", "<unk>").replace("< unk >", "<unk>")
    t = re.sub(r"\<((unk)[a-z ]+)\>", "<unk>", t)
    t = insert_space_between_mandarin(t)
    t = remove_redundant_whitespaces(t)
    return remove_repeated_noise(t, "<noise>")


def _iter_kaldi_text(lines: Iterable[str]) -> Iterator[tuple[str, str]]:
    for line in lines:
        parts = line.strip().split()
        if parts:
            yield parts[0], " ".join(parts[1:])


def write_mandarin_only_text(train_text: str, out_text: str,
                             char_file: str, bpe_char_file: str) -> int:
    """Spaced kaldi text + Mandarin char vocab files (preprocess.py:494-522).
    Returns the Mandarin vocab size."""
    counter: collections.Counter = collections.Counter()
    with open(train_text, encoding="utf-8") as fin, \
            open(out_text, "w", encoding="utf-8") as fp:
        for name, text in _iter_kaldi_text(fin):
            text = remove_redundant_whitespaces(
                insert_space_between_mandarin(text))
            if text:
                fp.write(f"{name} {text}\n")
            counter.update(extract_mandarin_only(text))
    vocab = sorted(counter.keys())
    with open(char_file, "w", encoding="utf-8") as fp:
        fp.write("\n".join(vocab))
    with open(bpe_char_file, "w", encoding="utf-8") as fp:
        fp.write("▁" + "\n▁".join(vocab) + "\n")
    return len(vocab)


def write_bpe_train_text(train_text: str, out_text: str) -> None:
    """English-only BPE training text (preprocess.py:524-546)."""
    with open(train_text, encoding="utf-8") as fin, \
            open(out_text, "w", encoding="utf-8") as fp:
        for name, text in _iter_kaldi_text(fin):
            text = extract_non_mandarin(remove_redundant_whitespaces(
                insert_space_between_mandarin(text)))
            if text:
                fp.write(f"{name} {text}\n")
