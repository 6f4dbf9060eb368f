"""Phoneme tokenizer: phoneme strings -> (phoneme, tone, lang, prosody) ids.

The port's own copy of cosyvoice_tpu/tokenizer/phoneme.py (pure Python, so
the two agree line for line; the port imports nothing of the JAX package).

Behavioral spec: reference `cosyvoice/tokenizer/phoneme_tokenizer.py:20-148` —
prosody marks (#1-#4/$1-$4) retro-annotate the previous phoneme's prosody id
and are dropped from the sequence; trailing 1-2 digits split off as tone;
tone 14 marks English; pause labels (<k>/<p>/<g>/<t>/<s>) kept or dropped by
`use_pause_label`.  The phoneme->id dict ships with the model assets
(hnttsa_phoneme2id.json: 140 phonemes).

The reference's 'inference' mode calls an external proprietary g2p frontend
(phoneme_tokenizer.py:31-39, hardcoded local path); plug any g2p through
`encode_text(g2p_fn)` here.
"""
from __future__ import annotations

import json
from typing import Callable, Optional, Sequence

_PUNC = {".", "。", ",", "，", "?", "？", "!", "！", ":", "：",
         ";", "；", "、", "·", "…", "—", "-", "|", "~", "'",
         "/", '"', "“", "”", "(", "（", ")", "）"}
_PAUSE = {"<k>", "<p>", "<g>", "<t>", "<s>"}
_PROSODY = {"#1", "#2", "#3", "#4", "$1", "$2", "$3", "$4"}


class PhonemeTokenizer:
    def __init__(self, phoneme_dict_path: str, use_pause_label: bool = True):
        with open(phoneme_dict_path, encoding="utf-8") as f:
            self.phoneme2id = json.load(f)
        self.use_pause_label = use_pause_label

    def encode(self, phonemes: Sequence[str]):
        """phoneme strings -> (pho_ids, tone_ids, lang_ids, prsd_ids)."""
        pho_ids, tone_ids, lang_ids, prsd_ids = [], [], [], []
        for phoneme in phonemes:
            if phoneme in _PROSODY:
                if prsd_ids:
                    prsd_ids[-1] = int(phoneme[-1])
                continue
            if not self.use_pause_label and phoneme in _PAUSE:
                continue
            if phoneme[-2:].isdigit():
                pho, tone_id = phoneme[:-2], int(phoneme[-2:])
            elif phoneme[-1].isdigit():
                pho, tone_id = phoneme[:-1], int(phoneme[-1])
            else:
                pho, tone_id = phoneme, 0
            pho_ids.append(self.phoneme2id[pho])
            tone_ids.append(tone_id)
            lang_ids.append(1 if tone_id == 14 else 0)
            prsd_ids.append(0)
        return pho_ids, tone_ids, lang_ids, prsd_ids

    def encode_with_prosody(self, phonemes: Sequence[str], tones: Sequence[int],
                            langs: Sequence[int]):
        """Pre-g2p'd streams (reference _extract_prosody, :125-147)."""
        pho_ids, tone_ids, lang_ids, prsd_ids = [], [], [], []
        for i, pho in enumerate(phonemes):
            if pho in _PROSODY:
                if prsd_ids:
                    prsd_ids[-1] = int(pho[-1])
                continue
            if not self.use_pause_label and pho in _PAUSE:
                continue
            pho_ids.append(self.phoneme2id[pho])
            tone_ids.append(tones[i])
            lang_ids.append(langs[i])
            prsd_ids.append(0)
        return pho_ids, tone_ids, lang_ids, prsd_ids

    def encode_text(self, text: str, g2p: Callable[[str], dict]):
        """text -> ids via an injected g2p returning {'pho','tone','lang'}."""
        r = g2p(text)
        return self.encode_with_prosody(r["pho"], r["tone"], r["lang"])
