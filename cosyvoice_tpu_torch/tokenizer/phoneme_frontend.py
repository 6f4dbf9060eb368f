"""g2p post-processing: external-frontend output -> token-aligned phonemes.

The port's own copy of cosyvoice_tpu/tokenizer/phoneme_frontend.py (pure Python, so
the two agree line for line; the port imports nothing of the JAX package).

Behavioral spec: reference `cosyvoice/tokenizer/phoneme_frontend.py:27-283`.
An external g2p frontend returns, for a normalized text, a dict with
``words`` (segmented words), ``symbols`` (per-word pinyin strings),
``prosody`` (per-char prosody marks '#0'..'#4'), ``phonemes`` (flat phoneme
list), ``pho2token_ids`` (phoneme -> char-index alignment), ``tones`` and
``language_ids``.  This module restructures that into per-character tokens
with aligned phoneme lists, restores manual pause tags (<k><p><s><g><t>)
that had to be stripped before g2p, merges erhua ('儿') into the preceding
character, and substitutes laughter/interjection pronunciations.

Pure text processing — no tensors; the output feeds PhonemeTokenizer.
"""
from __future__ import annotations

import copy
import json
import re
from typing import Callable, Optional

# English laughter pseudo-phonemes (reference phoneme_frontend.py:20-23)
ENG_LAUGHTER = {"haa15": "haa", "hee15": "hee", "hnn15": "hnn",
                "hii15": "hii", "hyy15": "hyy", "hoo15": "hoo"}
LAUGH2PHO = {v: k for k, v in ENG_LAUGHTER.items()}

_KPSGT = re.compile(r"<k>|<p>|<s>|<g>|<t>")


def load_interjections(tanci_json_path: Optional[str]) -> dict:
    """Interjection (叹词) -> pinyin map (reference assets/tanci.json)."""
    if tanci_json_path is None:
        return {}
    with open(tanci_json_path, encoding="utf-8") as f:
        return json.load(f)


def remove_kpsgt_tag(text: str):
    """Strip manual pause tags; return (clean text, [(tag, start, end)] with
    offsets measured in the whitespace-free text) — phoneme_frontend.py:108."""
    clean = _KPSGT.sub("", text)
    no_space = re.sub(r"\s", "", text)
    matches = [(m.group(), m.start(), m.end())
               for m in _KPSGT.finditer(no_space)]
    return clean, matches


def remove_word_boundary(result: dict):
    """Flatten word segmentation to per-char (chars, pinyins, prosody),
    merging erhua into the previous char (phoneme_frontend.py:63-107)."""
    chars, pinyins, prosody = [], [], []
    prsd_idx = 0
    prosody_with_er = result["prosody"]
    for word, symbol in zip(result["words"], result["symbols"]):
        word = word.strip()
        for j, s in enumerate(symbol.split(" ")):
            if s.startswith("@eng@"):
                n = len(s.replace("@eng@", ""))
                chars.append(word[j:j + n])
                pinyins.append(s)
                prosody.append(prosody_with_er[prsd_idx])
            elif s.startswith("@punc@") or word == "@#@":
                chars.append(word if s.startswith("@punc@") or word == "@#@"
                             else word[j])
                pinyins.append(s)
                prosody.append(prosody_with_er[prsd_idx])
            elif s == "@er@" and chars:
                # erhua: fold 儿 into the previous char, take its prosody
                chars[-1] += word[j]
                prosody[-1] = prosody_with_er[prsd_idx]
            else:
                chars.append(word[j])
                pinyins.append(s)
                prosody.append(prosody_with_er[prsd_idx])
            prsd_idx += 1
    return chars, pinyins, prosody


def token2phoneme_list(result: dict, token_length: int):
    """Group the flat phoneme stream by aligned char index
    (phoneme_frontend.py:27-61). Returns (per-token phoneme lists, counts)."""
    phonemes_list, counts = [], []
    cur, one, n = 0, [], 0
    for pho, adx in zip(result["phonemes"], result["pho2token_ids"]):
        if adx == cur:
            one.append(pho)
            n += 1
        elif adx == cur + 1:
            cur += 1
            phonemes_list.append(one.copy())
            counts.append(n)
            one, n = [pho], 1
        if adx == token_length - 1:
            phonemes_list.append(one.copy())
            counts.append(n)
            one, n = [], 0
    return phonemes_list, counts


def restore_prosody_tag(chars, prosody_tag, kpsgt_idx):
    """Insert the prosody values implied by manual tags back into the
    per-char prosody stream (phoneme_frontend.py:123-150). Consumes
    kpsgt_idx. <k>/<p> -> prosody 2; <t> -> repeat previous; else 1."""
    cnt, out = 0, []
    for char, prosody in zip(chars, prosody_tag):
        out.append(prosody[1:] if prosody in
                   {"#0", "#1", "#2", "#3", "#4"} else prosody)
        cnt += len(char)
        while kpsgt_idx and cnt == kpsgt_idx[0][1]:
            tag = kpsgt_idx[0][0]
            if tag in ("<k>", "<p>"):
                out.append("2")
            elif tag == "<t>":
                out.append(out[-1] if out else "1")
            else:
                out.append("1")
            cnt += len(tag)
            kpsgt_idx.pop(0)
    return out


def insert_kpsgt_into_tokens(chars, pinyins, phoneme_list, kpsgt_idx):
    """Re-insert manual tags as standalone tokens at their original char
    offsets (phoneme_frontend.py:152-172). Consumes kpsgt_idx."""
    cnt = 0
    nc, np_, nl = [], [], []
    for char, pinyin, phones in zip(chars, pinyins, phoneme_list):
        nc.append(char)
        np_.append(pinyin)
        nl.append(phones)
        cnt += len(char)
        while kpsgt_idx and cnt == kpsgt_idx[0][1]:
            tag = kpsgt_idx[0][0]
            nc.append(tag)
            np_.append(tag)
            nl.append([tag])
            cnt += len(tag)
            kpsgt_idx.pop(0)
    return nc, np_, nl


def insert_kpsgt_into_phonemes(pho, tone, lang, phoneme_list, token_prsd):
    """Insert the tag tokens (and their prosody markers) into the flat
    phoneme/tone/lang streams (phoneme_frontend.py:174-205)."""
    np_, nt, nl = [], [], []
    p_idx = 0
    for t_idx, word_phoneme in enumerate(phoneme_list):
        for p in word_phoneme:
            while pho[p_idx].startswith("#"):
                np_.append(pho[p_idx])
                nt.append(tone[p_idx])
                nl.append(lang[p_idx])
                p_idx += 1
            if not p.startswith("<"):
                assert p == pho[p_idx], (p, pho[p_idx])
                np_.append(pho[p_idx])
                nt.append(tone[p_idx])
                nl.append(lang[p_idx])
                p_idx += 1
            else:
                np_.append(p)
                nt.append(0)
                nl.append(0)
                prsd = int(token_prsd[t_idx])
                if prsd != 0:
                    np_.append(f"#{prsd}")
                    nt.append(0)
                    nl.append(0)
    return np_, nt, nl


def get_frontend_result(text: str, g2p: Callable[[str], dict],
                        interjection2pho: Optional[dict] = None) -> dict:
    """text (possibly with manual <kpsgt> tags) -> enriched frontend dict
    (phoneme_frontend.py:207-283).  `g2p` is the external frontend
    (reference: text_frontend_model.get_frontend_outputs); the returned dict
    gains 'text_token', 'pinyins', 'phoneme_list', 'token_prsd',
    'token2phonum', 'token2phonum_w_prsd', 'pho', 'tone', 'lang'."""
    interjection2pho = interjection2pho or {}
    input_text, kpsgt_idx = remove_kpsgt_tag(text)
    prosody_kpsgt_idx = copy.deepcopy(kpsgt_idx)
    result = g2p(input_text)
    kpsgt_num = len(kpsgt_idx)

    chars, pinyins, prosody = remove_word_boundary(result)
    assert len(chars) == len(pinyins) == len(prosody), result
    phoneme_list, _ = token2phoneme_list(result, len(chars))

    for j, char in enumerate(chars):
        if char.lower() in LAUGH2PHO:
            pinyins[j] = LAUGH2PHO[char.lower()]
    for j, char in enumerate(chars):
        if char.lower() in interjection2pho:
            pinyins[j] = interjection2pho[char.lower()]

    if kpsgt_num > 0:
        prosody = [int(p) for p in
                   restore_prosody_tag(chars, prosody, prosody_kpsgt_idx)]
        chars, pinyins, phoneme_list = insert_kpsgt_into_tokens(
            chars, pinyins, phoneme_list, kpsgt_idx)
        assert not prosody_kpsgt_idx and not kpsgt_idx, result
    else:
        prosody = [int(p[1:]) for p in prosody]

    token2phonum = [0 if p[0].startswith("<") else len(p)
                    for p in phoneme_list]
    result["ori_text"] = text
    result["text_token"] = chars
    result["pinyins"] = pinyins
    result["phoneme_list"] = phoneme_list
    result["token_prsd"] = prosody
    result["token2phonum"] = token2phonum

    with_prsd = []
    for i, n in enumerate(token2phonum):
        with_prsd.append(n)
        if int(prosody[i]) != 0:
            with_prsd.append(0)  # prosody placeholder token
    result["token2phonum_w_prsd"] = with_prsd

    pho, tone, lang = result["phonemes"], result["tones"], result["language_ids"]
    if kpsgt_num > 0:
        pho, tone, lang = insert_kpsgt_into_phonemes(
            pho, tone, lang, phoneme_list, prosody)
    result["pho"], result["tone"], result["lang"] = pho, tone, lang

    total = sum(n if n else 1 for n in with_prsd)
    assert total == len(result["pho"]), result
    return result
